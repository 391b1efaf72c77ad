// NBC's attention block with Transformer-XL relative positions, forward, on
// Hopper's bf16 tensor cores (sm_90a, mma.sync). The bf16 counterpart of
// attention_block_relpos.cu, which keeps the float32 inputs.
//
// For each of M sequences x[m] of T frames by H = 192 channels, with the
// folded operands of fold_weights_nbc and the tables sin, cos [T, H/2]:
//
//     xa = rnd([LayerNorm(x), 1, 0])
//     t  = rnd(xa rnd(A_h)),  gs = rnd(xa rnd(Gs_h)),  gc = rnd(xa rnd(Gc_h))
//     Aq = rnd(rnd(gs sin_i) + rnd(gc cos_i)),  Bq = rnd(rnd(gc sin_i) - rnd(gs cos_i))
//     s_ij = [t_i[:H] | Aq_i | Bq_i] . [xa_j[:H] | cos_j | sin_j] + t_i[H]   (float32)
//     e  = rnd(exp(s - rowmax s)),  vo = rnd(xa rnd(Wvo_h))[:, :H]
//     o_h = (e vo) / sum(e)  (float32),   y = rnd(((o_0 + o_1 + ...) + c) + x)
//
// with rnd() rounding to bf16 and the tables rounded too. These are the
// rounding points of the Pallas kernel it replaces for bf16 inputs
// (_fused_block_relpos / _kernel_relpos in nbss_tpu/ops/attention_block.py)
// and of ops/attention_block.py reference_relpos. As in attention_block_tc.cu,
// lane H+1 of xa is 0 for every real frame (the ragged key edge is masked by
// index) and the lane H of pv, the float32 sum of the rounded e through vo's
// ones lane (Wvo[H, H] = 1, Wvo[:H, H] = 0 from the fold), is the row sum of
// the rounded e.
//
// What bounds it on an H100: arithmetic. At NBC's serving shape (M = 16 *
// 257 = 4112, T = 248, 8 heads) the folded function does about 4.2 TFLOP:
// the projections [M T, 194] x [194, 8 * 584] (1.85), the scores over the
// 384-wide operands (1.55) and e vo (0.78); a 4.2 ms floor at 989 TFLOP/s.
//
// The design, per chunk of sequences (the wrapper sizes the chunk so that
// the workspaces fit RELPOS_TC_WORKSPACE_BYTES), three kernels:
//
//   1. relpos_tc_keys: the key operand K' = [xa[:H], rnd(cos_j), rnd(sin_j)]
//      [rows, 384] bf16, the same for every head, and every head's t[:, H]
//      = rnd(xa . A_h[:, H]) (one column, so a dot product here rather than
//      a column of the product), a warp per frame.
//   2. relpos_tc_proj: one tensor-core product of xa[:, :H] by every head's
//      folded weights, laid out once a call by relpos_tc_prep as bf16
//      columns [t (192) | gs, gc interleaved (192) | vo (192)] = 576 a head,
//      row H of each weight (the ones lane) added as a float32 bias. A block
//      keeps 256 rows of xa in registers (a warp 16 rows, 12 k-steps) and
//      streams the weights through shared memory 64 columns at a time
//      (cp.async, double-buffered), each block starting at another column
//      stage; every stage lies in one part of one head. Because gs_f and
//      gc_f are neighbouring columns, one thread's C fragment holds both of a
//      row, so Aq and Bq are formed in the epilogue with the rounded tables
//      of that row's frame, staged in shared memory where xa was. Each warp
//      rounds its [16, 64] outputs into a shared stage and writes them out
//      16 bytes a lane, whole 128-byte rows: the query operand Q'_h = [t[:H]
//      | Aq | Bq] [rows, 384] and vo_h [rows, 192] in bf16. (Written from the
//      fragments, 4 bytes a thread, the stores bounded the product.)
//   3. relpos_tc_attn: a persistent grid; a block takes (sequence, 128
//      queries) and walks the heads in order, a warp per 16-query tile with
//      its Q' fragments in registers (24 k-steps). Shared memory does not
//      hold a sequence's keys at H = 192 ([256, 384] of K' alone is 192 KB),
//      so both passes stream 32-key tiles through it (cp.async,
//      double-buffered) for all eight warps: pass 1 forms s = Q' K'^T +
//      t[:, H] with mma.sync m16n8k16 (keys >= T masked by index), keeps each
//      thread's own scores in its warp's slice of shared memory (16 KB a
//      warp at T <= 256; in a global workspace beyond T = 352) and the
//      row max, so the max is exact over all keys before any e is formed (no
//      online softmax); pass 2 streams vo_h, forms e = rnd(exp(s - m)) from
//      the kept scores straight into the A fragments of pv = e vo, and sums
//      e. Each thread adds its o_h = pv / sum(e) to the block's float32 head
//      sum, a slot [128, 192] in L2 that the same thread owns in every head
//      (the streamed tiles are marked evict-first so that they leave the
//      slots there), and at the last head writes y = rnd((acc + c) + x).
//
// Each thread reads back only the scores it wrote (the C fragment of a
// score tile and the A fragment of e cover the same elements), so the kept
// scores need no barrier. No atomics: two launches give the same bits. H =
// 192 only; any nh that divides H, any T >= 1 and M >= 1.

#include <algorithm>

#include "attention_block_tc.cuh"

namespace {

using namespace nbss_mma;
using nbss_block::bf16;
using nbss_block::load_a;
using nbss_block::LOG2E;
using nbss_block::mma_rows;
using nbss_block::mma_tile_t;
using nbss_block::warp_sum;
using nbss_block::Width;

constexpr int H = 192;                 // channels the kernel is built for
constexpr int HA = H + 2;              // rows of the folded operands
constexpr int D2 = H / 2;              // position frequencies
constexpr int KQ = 2 * H;              // 384: width of the score operands Q' and K'
constexpr int PN = 64;                 // projection columns a stage
constexpr int C_GS = H;                // gs_f at C_GS + 2f, gc_f at C_GS + 2f + 1
constexpr int C_VO = C_GS + 2 * D2;    // vo
constexpr int PC = C_VO + H;           // 576 projection columns a head: t, gs and gc, vo
constexpr int ST_HEAD = PC / PN;       // 9 column stages a head, 3 of each part
static_assert(PC % PN == 0 && H % PN == 0, "every column stage lies in one part");

using WQ = Width<KQ>;                  // the score operands as [*][392] tiles
using WV = Width<H>;                   // xa, the weights and vo as [*][200] tiles

constexpr int NT = 256;                // threads of the attention blocks
constexpr int NW = NT / 32;

// relpos_tc_proj
constexpr int PW = 16;                 // warps a block, 16 rows each
constexpr int PM = PW * 16;            // rows a block
constexpr int OLS = PN + 8;            // row stride of a warp's output stage
constexpr int PROJ_SMEM = (PM + 2 * PN) * WV::LS * 2 + PW * 16 * OLS * 2;

// relpos_tc_attn
constexpr int QT = NW;                 // query tiles of 16 a block, a warp each
constexpr int KT = 32;                 // keys a stage
constexpr int KU = KT / 16;            // 16-key blocks a stage
constexpr int KBUF = KT * WQ::LS;      // bf16 elements of one key buffer (also holds a vo tile)
constexpr int QSTAGE = 16 * WQ::LS * 2;  // bytes of a warp's staged Q' tile
static_assert(KT * WV::LS <= KBUF, "a vo tile fits a key buffer");

// K' = [rnd(LayerNorm(x)), rnd(cos_t), rnd(sin_t)] for `rows` frames (frame
// t = row % T), and every head's t[:, H] = rnd(xa . rnd(A_h[:, H])) (acol:
// [nh][H + 1], row H the ones lane's), a warp per frame.
__global__ void __launch_bounds__(256) relpos_tc_keys(const bf16* __restrict__ x,
                                                      const float* __restrict__ ln,
                                                      const float* __restrict__ sin,
                                                      const float* __restrict__ cos,
                                                      const float* __restrict__ acol,
                                                      bf16* __restrict__ xk,
                                                      float* __restrict__ tq, int rows, int T,
                                                      int nh, float eps) {
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
  bf16* out = xk + size_t(warp) * KQ;
  const size_t t = size_t(warp % T) * D2;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    const int col = lane + 32 * k;
    v[k] = round_bf16(v[k] * rs * ln[col] + ln[H + col]);
    out[col] = __float2bfloat16(v[k]);
    out[H + col] = __float2bfloat16(col < D2 ? cos[t + col] : sin[t + col - D2]);
  }
  for (int h = 0; h < nh; ++h) {
    const float* ac = acol + size_t(h) * (H + 1);
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < H / 32; ++k) d = fmaf(v[k], ac[lane + 32 * k], d);
    d = warp_sum(d);
    if (lane == 0) tq[size_t(h) * rows + warp] = round_bf16(d + ac[H]);
  }
}

// wT[n][k] = rnd(W[k][n]) for the nh * PC projection columns n (see the
// column blocks above) and the H channels k; wb[n] = rnd(W[H][n]), the ones
// lane's row; acol[h][k] = rnd(A_h[k][H]) for k <= H. Once a call.
__global__ void __launch_bounds__(256) relpos_tc_prep(const float* __restrict__ A,
                                                      const float* __restrict__ Gs,
                                                      const float* __restrict__ Gc,
                                                      const float* __restrict__ Wvo,
                                                      bf16* __restrict__ wT, float* __restrict__ wb,
                                                      float* __restrict__ acol, int nh) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nh * PC * (H + 1)) return;
  const int n = idx / (H + 1), k = idx % (H + 1), h = n / PC, cc = n % PC;
  const size_t ra = (size_t(h) * HA + k) * HA, rg = (size_t(h) * HA + k) * D2;
  float w;
  if (cc < C_GS) w = A[ra + cc];
  else if (cc < C_VO) w = ((cc - C_GS) & 1 ? Gc : Gs)[rg + (cc - C_GS) / 2];
  else w = Wvo[ra + cc - C_VO];
  if (k < H) wT[size_t(n) * H + k] = __float2bfloat16(w);
  else wb[n] = round_bf16(w);
  if (cc == 0) acol[size_t(h) * (H + 1) + k] = round_bf16(A[ra + H]);
}

struct ProjArgs {
  const bf16* xk;   // [rows, KQ]
  const bf16* wT;   // [ncols, H]
  const float* wb;  // [ncols]
  bf16* qw;         // [nh, rows, KQ]: [t[:H] | Aq | Bq]
  bf16* vw;         // [nh, rows, H]: vo[:, :H]
  int rows, ncols;
};

__global__ void __launch_bounds__(PW * 32, 1) relpos_tc_proj(const ProjArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* XS = reinterpret_cast<bf16*>(smem_raw);  // [PM][LS] xa rows, then their tables
  bf16* WS = XS + PM * WV::LS;                   // [2][PN][LS] weight columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  bf16* OS = WS + 2 * PN * WV::LS + warp * 16 * OLS;  // [16][OLS] this warp's outputs
  const int r0 = blockIdx.x * PM;
  const int nct = a.ncols / PN;

  auto stage_w = [&](int ct, int buf) {
    bf16* dst = WS + buf * PN * WV::LS;
    for (int idx = tid; idx < PN * (H / 8); idx += PW * 32) {
      const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
      cp_async16(dst + r * WV::LS + c, a.wT + size_t(ct * PN + r) * H + c);
    }
  };
  for (int idx = tid; idx < PM * (H / 8); idx += PW * 32) {
    const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
    if (r0 + r < a.rows)
      cp_async16(XS + r * WV::LS + c, a.xk + size_t(r0 + r) * KQ + c);
    else
      *reinterpret_cast<uint4*>(XS + r * WV::LS + c) = make_uint4(0, 0, 0, 0);
  }
  stage_w(blockIdx.x % nct, 0);
  cp_async_wait_all();
  __syncthreads();
  uint32_t F[H / 16][4];
  load_a<H>(F, XS, warp * 16, lane);
  __syncthreads();  // xa is in registers: XS now takes the rows' rounded tables [cos | sin]
  for (int idx = tid; idx < PM * (H / 8); idx += PW * 32) {
    const int r = idx / (H / 8), c = (idx % (H / 8)) * 8;
    if (r0 + r < a.rows) cp_async16(XS + r * WV::LS + c, a.xk + size_t(r0 + r) * KQ + H + c);
  }
  cp_async_wait_all();
  __syncthreads();

  // the column stages in a rotated order, so that the blocks in flight read
  // different weights and no few L2 lines serve every SM at once
  for (int it = 0; it < nct; ++it) {
    const int buf = it & 1, ct = (blockIdx.x + it) % nct;
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();  // weight stage it is in; every warp is done with stage it - 1
    }
    if (it + 1 < nct) stage_w((blockIdx.x + it + 1) % nct, buf ^ 1);
    float c[PN / 16][2][4];
    mma_rows<PN / 16, false, H>(c, F, WS + buf * PN * WV::LS, 0, lane);
    const int h = ct / ST_HEAD, part = (ct % ST_HEAD) / 3, j = ct % 3;  // part: t, gs/gc, vo
    // this warp's [16, PN] outputs, rounded, into its stage
#pragma unroll
    for (int u = 0; u < PN / 16; ++u)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int cl = u * 16 + n * 8 + 2 * t4, col = ct * PN + cl;
        const float b0 = a.wb[col], b1 = a.wb[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = g4 + 8 * hf;
          const float v0 = c[u][n][2 * hf] + b0, v1 = c[u][n][2 * hf + 1] + b1;
          if (part != 1) {
            *reinterpret_cast<uint32_t*>(OS + rl * OLS + cl) = pack(v0, v1);
          } else {  // gs_f, gc_f -> Aq_f, Bq_f, with the rounded tables of the row's frame
            const int fl = cl / 2, f = j * (PN / 2) + fl;
            const bf16* tab = XS + (warp * 16 + rl) * WV::LS;
            const float co = __bfloat162float(tab[f]), si = __bfloat162float(tab[D2 + f]);
            const float gs = round_bf16(v0), gc = round_bf16(v1);
            OS[rl * OLS + fl] = __float2bfloat16(__fadd_rn(round_bf16(__fmul_rn(gs, si)),
                                                           round_bf16(__fmul_rn(gc, co))));
            OS[rl * OLS + PN / 2 + fl] = __float2bfloat16(
                __fsub_rn(round_bf16(__fmul_rn(gc, si)), round_bf16(__fmul_rn(gs, co))));
          }
        }
      }
    __syncwarp();
    // the stage to its rows, 16 bytes a lane
#pragma unroll
    for (int i = 0; i < 16 * PN / 8 / 32; ++i) {
      const int idx = lane + 32 * i, rl = idx / (PN / 8), ch = idx % (PN / 8);
      const int r = r0 + warp * 16 + rl;
      if (r >= a.rows) continue;
      bf16* dst;
      if (part == 0)
        dst = a.qw + (size_t(h) * a.rows + r) * KQ + j * PN + ch * 8;
      else if (part == 1)  // Aq_f to Q'[H + f], Bq_f to Q'[H + D2 + f]
        dst = a.qw + (size_t(h) * a.rows + r) * KQ + H + (ch < PN / 16 ? 0 : D2 - PN / 2) +
              j * (PN / 2) + ch * 8;
      else
        dst = a.vw + (size_t(h) * a.rows + r) * H + j * PN + ch * 8;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(OS + rl * OLS + ch * 8);
    }
    __syncwarp();
  }
}

struct AttnArgs {
  const bf16* xk;   // [rows, KQ] key operand
  const bf16* qw;   // [nh, rows, KQ]
  const float* tq;  // [nh, rows]
  const bf16* vw;   // [nh, rows, H]
  const bf16* x;    // [mc, T, H] this chunk's input
  const float* c;   // [H]
  bf16* y;          // [mc, T, H]
  float* acc;       // [gridDim.x][QT * 16][H] head sums
  float* sg;        // [gridDim.x][QT][Tk * 16] kept scores, or null when they sit in shared memory
  int mc, T, nh, rows;
  int region;       // bytes of a warp's slice of shared memory
};

__global__ void __launch_bounds__(NT, 1) relpos_tc_attn(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* KB = reinterpret_cast<bf16*>(smem_raw);  // [2][KBUF] key or vo tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  unsigned char* mine = smem_raw + 2 * KBUF * 2 + size_t(warp) * a.region;
  bf16* QS = reinterpret_cast<bf16*>(mine);  // [16][WQ::LS] this warp's Q' tile
  const int T = a.T;
  const int Tk = (T + KT - 1) / KT * KT, nkt = Tk / KT;
  float* sc = a.sg ? a.sg + (size_t(blockIdx.x) * QT + warp) * Tk * 16
                   : reinterpret_cast<float*>(mine);  // this warp's kept scores
  const int ntile = (T + 15) / 16, ngroups = (ntile + QT - 1) / QT;
  float* acc = a.acc + (size_t(blockIdx.x) * QT * 16 + warp * 16) * H;
  // The key, vo and Q' tiles stream through L2 marked evict-first, so that
  // they do not push the blocks' head-sum slots out of it (without the mark
  // the call at NBC's serving shape was slower on an H100).
  const uint64_t pol = evict_first();

  auto stage_keys = [&](size_t rb, int kt, int buf) {
    bf16* dst = KB + buf * KBUF;
    for (int idx = tid; idx < KT * (KQ / 8); idx += NT) {
      const int r = idx / (KQ / 8), cc = (idx % (KQ / 8)) * 8, j = kt * KT + r;
      if (j < T)
        cp_async16_ef(dst + r * WQ::LS + cc, a.xk + (rb + j) * KQ + cc, pol);
      else
        *reinterpret_cast<uint4*>(dst + r * WQ::LS + cc) = make_uint4(0, 0, 0, 0);
    }
  };
  auto stage_vo = [&](const bf16* vh, int kt, int buf) {
    bf16* dst = KB + buf * KBUF;
    for (int idx = tid; idx < KT * (H / 8); idx += NT) {
      const int r = idx / (H / 8), cc = (idx % (H / 8)) * 8, j = kt * KT + r;
      if (j < T)
        cp_async16_ef(dst + r * WV::LS + cc, vh + size_t(j) * H + cc, pol);
      else
        *reinterpret_cast<uint4*>(dst + r * WV::LS + cc) = make_uint4(0, 0, 0, 0);
    }
  };

  for (int item = blockIdx.x; item < a.mc * ngroups; item += gridDim.x) {
    const int m = item / ngroups, qt = (item % ngroups) * QT + warp;
    const bool active = qt < ntile;  // warp-uniform
    const int q0 = qt * 16;
    const size_t rb = size_t(m) * T;
    for (int h = 0; h < a.nh; ++h) {
      const bf16* qh = a.qw + (size_t(h) * a.rows + rb) * KQ;
      const bf16* vh = a.vw + (size_t(h) * a.rows + rb) * H;
      __syncthreads();  // the last head is done with the key buffers and the warp slices
      if (active) {
        for (int idx = lane; idx < 16 * (KQ / 8); idx += 32) {
          const int r = idx / (KQ / 8), cc = (idx % (KQ / 8)) * 8;
          if (q0 + r < T)
            cp_async16_ef(QS + r * WQ::LS + cc, qh + size_t(q0 + r) * KQ + cc, pol);
          else
            *reinterpret_cast<uint4*>(QS + r * WQ::LS + cc) = make_uint4(0, 0, 0, 0);
        }
      }
      stage_keys(rb, 0, 0);
      float cq[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = q0 + g4 + 8 * hf;
        cq[hf] = active && i < T ? a.tq[size_t(h) * a.rows + rb + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      uint32_t QF[KQ / 16][4];
      if (active) load_a<KQ>(QF, QS, 0, lane);
      __syncwarp();  // the Q' tile is in registers; its slice now keeps scores

      // pass 1: the scores of every key, kept, and the row max
      float mx[2] = {-INFINITY, -INFINITY};
      for (int kt = 0; kt < nkt; ++kt) {
        if (kt > 0) {
          cp_async_wait_all();
          __syncthreads();
        }
        if (kt + 1 < nkt) stage_keys(rb, kt + 1, (kt + 1) & 1);
        if (!active) continue;
        float s[KU][2][4];
        mma_rows<KU, false, KQ>(s, QF, KB + (kt & 1) * KBUF, 0, lane);
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
            *reinterpret_cast<float4*>(sc + (((kt * KU + u) * 2 + n) * 32 + lane) * 4) =
                make_float4(s[u][n][0], s[u][n][1], s[u][n][2], s[u][n][3]);
          }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);

      // pass 2: e = rnd(exp(s - m)) from the kept scores, pv = e vo and sum(e)
      __syncthreads();  // every warp is done with the last key tile
      stage_vo(vh, 0, 0);
      const bool first = h == 0, last = h == a.nh - 1;
      float O[H / 8][4];
#pragma unroll
      for (int n = 0; n < H / 8; ++n) O[n][0] = O[n][1] = O[n][2] = O[n][3] = 0.f;
      float l[2] = {0.f, 0.f};
      for (int kt = 0; kt < nkt; ++kt) {
        cp_async_wait_all();
        __syncthreads();
        if (kt + 1 < nkt) stage_vo(vh, kt + 1, (kt + 1) & 1);
        if (!active) continue;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          float e[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float4 sv =
                *reinterpret_cast<const float4*>(sc + (((kt * KU + u) * 2 + n) * 32 + lane) * 4);
            const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              e[n][q] = round_bf16(ex2((s4[q] - mx[q >> 1]) * LOG2E));
              l[q >> 1] += e[n][q];
            }
          }
          uint32_t P[4];
          pack_a(P, e[0], e[1]);
          mma_tile_t<H>(O, P, KB + (kt & 1) * KBUF, u * 16, lane);
        }
      }
      if (!active) continue;
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);

      // acc += pv / sum(e); at the last head y = rnd((acc + c) + x)
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

size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// Scores sit in shared memory when every warp's slice of them fits beside the
// key buffers; otherwise in a global workspace.
bool scores_in_smem(int T) {
  const size_t Tk = (T + KT - 1) / KT * KT;
  return 2 * KBUF * 2 + QT * std::max<size_t>(QSTAGE, Tk * 64) <= 232448;
}

int attn_region(int T) {
  const int Tk = (T + KT - 1) / KT * KT;
  return scores_in_smem(T) ? std::max(QSTAGE, Tk * 64) : QSTAGE;
}

// The workspace's parts, in bytes, in order.
struct Layout {
  size_t wT, wb, acol, xk, qw, tq, vw, acc, sg, total;
  Layout(int chunk, int T, int nh, int nblocks) {
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
    const size_t rows = size_t(chunk) * T, Tk = (T + KT - 1) / KT * KT;
    wT = take(size_t(nh) * PC * H * 2);
    wb = take(size_t(nh) * PC * 4);
    acol = take(size_t(nh) * (H + 1) * 4);
    xk = take(rows * KQ * 2);
    qw = take(size_t(nh) * rows * KQ * 2);
    tq = take(size_t(nh) * rows * 4);
    vw = take(size_t(nh) * rows * H * 2);
    acc = take(size_t(nblocks) * QT * 16 * H * 4);
    sg = take(scores_in_smem(T) ? 0 : size_t(nblocks) * QT * Tk * 16 * 4);
    total = off;
  }
};

}  // namespace

// Bytes of workspace the tensor-core forward needs for chunks of `chunk`
// sequences of T frames, nh heads and nblocks persistent attention blocks.
extern "C" long long nbss_attention_block_relpos_tc_workspace_bytes(int chunk, int T, int nh,
                                                                    int nblocks) {
  return static_cast<long long>(Layout(chunk, T, nh, nblocks).total);
}

// y = the folded NBC attention block of x, bf16, on `stream`. x, y [M, T, H]
// bfloat16; ln [2, H], A, Wvo [nh, H+2, H+2], Gs, Gc [nh, H+2, H/2], c [H],
// sin, cos [T, H/2] float32; all contiguous. ws: the workspace's bytes for
// (chunk, T, nh, nblocks), 256-byte aligned, any content. Sequences go
// through it `chunk` at a time; nblocks (>= 1) persistent attention blocks.
// Returns the CUDA error of the launches (0 on success); shapes the kernel is
// not built for return cudaErrorInvalidValue without launching.
extern "C" int nbss_attention_block_relpos_tc_fwd(const void* x, const void* ln, const void* A,
                                                  const void* Gs, const void* Gc,
                                                  const void* Wvo, const void* c,
                                                  const void* sin, const void* cos, void* y,
                                                  void* ws, int M, int T, int Hx, int nh,
                                                  int chunk, int nblocks, float eps,
                                                  void* stream) {
  if (M < 1 || T < 1 || Hx != H || nh < 1 || H % nh != 0 || chunk < 1 || nblocks < 1 ||
      (long long)chunk * T * KQ > 2147483647LL || (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L(chunk, T, nh, nblocks);
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* wT = reinterpret_cast<bf16*>(base + L.wT);
  float* wb = reinterpret_cast<float*>(base + L.wb);
  float* acol = reinterpret_cast<float*>(base + L.acol);
  bf16* xk = reinterpret_cast<bf16*>(base + L.xk);
  bf16* qw = reinterpret_cast<bf16*>(base + L.qw);
  float* tq = reinterpret_cast<float*>(base + L.tq);
  bf16* vw = reinterpret_cast<bf16*>(base + L.vw);
  float* acc = reinterpret_cast<float*>(base + L.acc);
  float* sg = scores_in_smem(T) ? nullptr : reinterpret_cast<float*>(base + L.sg);
  const int ncols = nh * PC;
  relpos_tc_prep<<<(ncols * (H + 1) + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(A), static_cast<const float*>(Gs), static_cast<const float*>(Gc),
      static_cast<const float*>(Wvo), wT, wb, acol, nh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int region = attn_region(T);
  const int attn_smem = 2 * KBUF * 2 + QT * region;
  err = cudaFuncSetAttribute(relpos_tc_proj, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PROJ_SMEM);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(relpos_tc_attn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             attn_smem);
  if (err != cudaSuccess) return int(err);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  const int ngroups = ((T + 15) / 16 + QT - 1) / QT;
  for (int m0 = 0; m0 < M; m0 += chunk) {
    const int mc = M - m0 < chunk ? M - m0 : chunk;
    const int rows = mc * T;
    const bf16* xc = xb + size_t(m0) * T * H;
    relpos_tc_keys<<<(rows + 7) / 8, 256, 0, s>>>(xc, static_cast<const float*>(ln),
                                                  static_cast<const float*>(sin),
                                                  static_cast<const float*>(cos), acol, xk, tq,
                                                  rows, T, nh, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    const ProjArgs pa{xk, wT, wb, qw, vw, rows, ncols};
    relpos_tc_proj<<<(rows + PM - 1) / PM, PW * 32, PROJ_SMEM, s>>>(pa);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    const int items = mc * ngroups;
    const AttnArgs aa{xk, qw, tq, vw, xc, static_cast<const float*>(c), yb + size_t(m0) * T * H,
                      acc, sg, mc, T, nh, rows, region};
    relpos_tc_attn<<<items < nblocks ? items : nblocks, NT, attn_smem, s>>>(aa);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}
