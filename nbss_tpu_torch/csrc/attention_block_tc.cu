// Narrow-band attention block, forward, on Hopper's bf16 tensor cores
// (sm_90a, mma.sync). The bf16 counterpart of attention_block.cu, which
// keeps the float32 inputs.
//
// For each of M sequences x[m] of T <= 256 frames by H = 96 channels,
//
//     y = x + sum_h softmax(xa A_h xa^T) (xa Wvo_h)[:, :H] + c,
//     xa = [LN(x), 1, 0]
//
// with the folded operands of fold_weights(). Replaces the Pallas TPU
// kernel _fused_block / _kernel in nbss_tpu/ops/attention_block.py for bf16
// inputs, at its rounding points: xa, t = xa A_h, vo = xa Wvo_h and the
// unnormalised weights e = exp(s - rowmax(s)) are rounded to bf16, exactly
// where they become mma operands; pv = e vo is summed in float32 and divided
// by the float32 row sum of the rounded e (the Pallas kernel's lane H of pv,
// vo's ones lane); the heads are summed in float32 in head order and y =
// round(acc + c + x) is written once.
//
// What bounds it on an H100: arithmetic. At the flagship shape (M = 2064,
// T = 251, nh = 4) x and y are 199 MB (59 us at 3.35 TB/s). The unfolded
// function (the q/k/v projections, scores and values over dh = 24, the out
// projection) is 88 GFLOP, 89 us at 989 TFLOP/s; this kernel computes the
// folded function, whose scores and values run over all 96 channels: about
// 276 GFLOP over 256-frame tiles, a 0.28 ms floor. So it may stay slower
// than one library call of the unfolded function.
//
// The design. A persistent grid over the sequences, one block of 8 warps a
// sequence at a time, keeps xa and per head t and vo of every frame in
// shared memory as bf16 [256, 96] tiles (3 x 53 KB), so vo_h is formed once
// per head and sequence, and per head runs
//
//   P1 projections, a warp per 16-frame tile: t = xa A_h and vo = xa Wvo_h
//      on mma.sync m16n8k16 over the 96 channels (6 k-steps), row H of A_h
//      and Wvo_h added as float32 biases before the rounding; t[:, H] (the
//      per-row constant of the scores) kept as float32. A_h^T and Wvo_h^T
//      are staged as bf16 tiles, the next head's while this head's query
//      pass runs.
//   P2 query pass, a pair of warps per 16-query tile, each warp one half of
//      the keys (8 blocks of 16, 64 score registers a thread): s = t xa^T +
//      t[:, H] (keys >= T masked by index), the pair exchanges the row max
//      through shared memory, so it is exact over all keys before any e is
//      formed (no online softmax), e = round(exp(s - m)) goes from the
//      accumulator straight into the A fragments of pv = e vo, and the pair
//      exchanges its row sums and one half of its products, so each warp
//      finishes 48 of the 96 columns: o_h = pv / sum(e), added in float32 to
//      the tile's running head sum, which lives in a per-block float32 slot
//      [256, 96] (L2-resident; the same thread owns the same elements in
//      every head), and at the last head y = round(acc + c + x).
//
// No [T, T] matrix, no t, vo or partial output reaches device memory beyond
// that slot; x is read twice (LayerNorm, residual), y written once; no
// atomics, so two launches give the same bits.
//
// What holds it back: the three tiles, the staged weights and the pairs'
// exchange take 224 KB of shared memory, so an SM runs one block of 8 warps,
// and each 16-query tile's products are short chains (6 k-steps) between
// exchanges.

#include "attention_block_tc.cuh"

namespace {

using namespace nbss_block;

constexpr int NW = 8;                      // warps per block
constexpr int NT = NW * 32;
constexpr int NG = NW / 2;                 // query tiles in flight, a pair of warps each
constexpr int NP = TMAX / 32;              // 16-key blocks of one warp's half of the keys

// The kernel's sizes for CH channels (built for 96).
template <int CH>
struct Dims : Width<CH> {
  using Width<CH>::LS;
  using Width<CH>::NC;
  static constexpr int HALF = NC / 2;        // n-tiles of the columns a warp finishes
  static constexpr int AT_ROWS = (CH + 2 + 15) / 16 * 16;  // A_h^T staged, rows CH+2.. zero
  static constexpr int TILE_BYTES = TMAX * LS * 2;
  static constexpr int WT_BYTES = (AT_ROWS + CH) * LS * 2;
  static constexpr int XCH = 2 * 16 + 2 * 16 + 2 * HALF * 4 * 32;  // a pair's max, sums, products
  static constexpr int SMEM_BYTES = 3 * TILE_BYTES + WT_BYTES + TMAX * 4 + NG * XCH * 4;
};

template <int CH>
__global__ void __launch_bounds__(NT, 1)
attention_block_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln,
                          const bf16* __restrict__ wts, const float* __restrict__ vecs,
                          const float* __restrict__ cvec, bf16* __restrict__ y,
                          float* __restrict__ acc_ws, int M, int T, int nh, float eps) {
  using D = Dims<CH>;
  constexpr int H = CH, LS = D::LS, KS = D::KS, NC = D::NC, HALF = D::HALF;
  constexpr int AT_N = D::AT_N, AT_ROWS = D::AT_ROWS, CPL = H / 32;  // channels a lane holds
  static_assert(D::SMEM_BYTES <= 232448, "over the 227 KB a block may use");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* XA = reinterpret_cast<bf16*>(smem_raw);  // [TMAX][LS] xa (lanes < H); rows >= T zero
  bf16* TS = XA + TMAX * LS;                      // [TMAX][LS] t of head h
  bf16* VO = TS + TMAX * LS;                      // [TMAX][LS] vo of head h
  bf16* ATs = VO + TMAX * LS;                     // [AT_ROWS][LS] A_h^T
  bf16* WTs = ATs + AT_ROWS * LS;                 // [H][LS] Wvo_h^T
  float* cs = reinterpret_cast<float*>(WTs + H * LS);  // [TMAX] t[:, H]
  float* xch = cs + TMAX;                              // [NG][D::XCH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int grp = warp >> 1, hf = warp & 1;
  const int ntile = (T + 15) / 16;
  const int kb0 = hf * NP;                           // this warp's first key block
  const int nkb = max(0, min(NP, ntile - kb0));      // and how many of its blocks hold keys
  float* acc = acc_ws + size_t(blockIdx.x) * TMAX * H;
  float* xmx = xch + grp * D::XCH;  // [2][16] each warp's row max
  float* xl = xmx + 32;          // [2][16] each warp's row sums
  float* xo = xl + 32;           // [2][HALF][4][32] the products each warp hands over

  auto stage_head = [&](int h) {
    const bf16* w = wts + size_t(h) * D::WTS_PER_HEAD;
    stage_weights<H>(ATs, w, AT_N, AT_ROWS, tid, NT);
    stage_weights<H>(WTs, w + AT_N * H, H, H, tid, NT);
  };
  stage_head(0);

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t row0 = size_t(m) * T;
    const bf16* xm = x + row0 * H;
    bf16* ym = y + row0 * H;
    __syncthreads();  // the previous sequence is done with XA

    // P0. xa = round(LN(x)) of every frame; rows T .. 16 ntile - 1 zero
    for (int j = warp; j < ntile * 16; j += NW) {
      bf16* row = XA + j * LS;
      if (j < T) {
        float v[CPL], sum = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          v[c] = __bfloat162float(xm[j * H + lane + 32 * c]);
          sum += v[c];
        }
        const float mu = warp_sum(sum) / float(H);
        float d2 = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          v[c] -= mu;
          d2 = fmaf(v[c], v[c], d2);
        }
        const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int k = lane + 32 * c;
          row[k] = __float2bfloat16(v[c] * rs * ln[k] + ln[H + k]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) row[lane + 32 * c] = __float2bfloat16(0.f);
      }
    }

    for (int h = 0; h < nh; ++h) {
      const float* abias = vecs + size_t(h) * D::VEC_PER_HEAD;
      const float* wbias = abias + AT_N;
      cp_async_wait_all();
      __syncthreads();  // xa and head h's weights are in; the last pass is done with TS, VO, cs

      // P1. t = round(xa A_h) (t[:, H] into cs), vo = round(xa Wvo_h)
      for (int rt = warp; rt < ntile; rt += NW) {
        uint32_t F[KS][4];
        load_a<H>(F, XA, rt * 16, lane);
        auto store = [&](bf16* tile, const float (&c)[4], const float* bias, int n) {
          const float b0 = bias[n * 8 + 2 * t4], b1 = bias[n * 8 + 2 * t4 + 1];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = rt * 16 + g4 + 8 * r;
            *reinterpret_cast<uint32_t*>(tile + i * LS + n * 8 + 2 * t4) =
                i < T ? pack(c[2 * r] + b0, c[2 * r + 1] + b1) : 0u;
          }
        };
#pragma unroll 1
        for (int n0 = 0; n0 < NC; n0 += 4) {
          float c[2][2][4];
          mma_rows<2, false, H>(c, F, ATs, n0 * 8, lane);
#pragma unroll
          for (int u = 0; u < 4; ++u) store(TS, c[u / 2][u % 2], abias, n0 + u);
          mma_rows<2, false, H>(c, F, WTs, n0 * 8, lane);
#pragma unroll
          for (int u = 0; u < 4; ++u) store(VO, c[u / 2][u % 2], wbias, n0 + u);
        }
        float c[1][2][4];
        mma_rows<1, false, H>(c, F, ATs, NC * 8, lane);  // columns H.. of t: t[:, H]
        if (t4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = rt * 16 + g4 + 8 * r;
            cs[i] = i < T ? round_bf16(c[0][0][2 * r] + abias[H]) : 0.f;
          }
        }
      }
      __syncthreads();
      // the next head's weights (or the next sequence's first) while the query pass runs
      if (h + 1 < nh)
        stage_head(h + 1);
      else if (m + gridDim.x < M)
        stage_head(0);

      // P2. query pass: warp hf of the pair takes key blocks kb0 .. kb0 + nkb - 1
      const bool first = h == 0, last = h == nh - 1;
      for (int qt = grp; qt < ntile; qt += NG) {
        const int q0 = qt * 16;
        uint32_t F[KS][4];
        load_a<H>(F, TS, q0, lane);
        const float cq[2] = {cs[q0 + g4], cs[q0 + g4 + 8]};
        float S[NP][2][4];
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (p < nkb) {
            score_tile<H>(S[p], F, XA, kb0 + p, T, cq, lane);
#pragma unroll
            for (int r = 0; r < 2; ++r)
              mx[r] = fmaxf(mx[r], fmaxf(fmaxf(S[p][0][2 * r], S[p][0][2 * r + 1]),
                                         fmaxf(S[p][1][2 * r], S[p][1][2 * r + 1])));
          }
        }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
        if (t4 == 0) {
          xmx[hf * 16 + g4] = mx[0];
          xmx[hf * 16 + g4 + 8] = mx[1];
        }
        named_barrier(1 + grp, 64);
        mx[0] = fmaxf(xmx[g4], xmx[16 + g4]);
        mx[1] = fmaxf(xmx[g4 + 8], xmx[16 + g4 + 8]);

        // e = round(exp(s - m)), its sum, and pv = e vo over this warp's keys
        float l[2] = {0.f, 0.f};
        float O[NC][4] = {};
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (p < nkb) {
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float v = round_bf16(ex2((S[p][n][e] - mx[e >> 1]) * LOG2E));
                S[p][n][e] = v;
                l[e >> 1] += v;
              }
            uint32_t P[4];
            pack_a(P, S[p][0], S[p][1]);
            mma_tile_t<H>(O, P, VO, (kb0 + p) * 16, lane);
          }
        }
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);

        // hand the partner's half of the columns over, take this warp's half back
        float* give = xo + hf * (HALF * 4 * 32);
        const float* take = xo + (1 - hf) * (HALF * 4 * 32);
        if (hf == 0) {
#pragma unroll
          for (int i = 0; i < HALF; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) give[(i * 4 + e) * 32 + lane] = O[HALF + i][e];
        } else {
#pragma unroll
          for (int i = 0; i < HALF; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) give[(i * 4 + e) * 32 + lane] = O[i][e];
        }
        if (t4 == 0) {
          xl[hf * 16 + g4] = l[0];
          xl[hf * 16 + g4 + 8] = l[1];
        }
        named_barrier(1 + grp, 64);
        const float lt[2] = {xl[g4] + xl[16 + g4], xl[g4 + 8] + xl[16 + g4 + 8]};
        float o[HALF][4];  // the pair's pv over all keys, columns hf * H / 2 ..
        if (hf == 0) {
#pragma unroll
          for (int i = 0; i < HALF; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] = O[i][e] + take[(i * 4 + e) * 32 + lane];
        } else {
#pragma unroll
          for (int i = 0; i < HALF; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] = take[(i * 4 + e) * 32 + lane] + O[HALF + i][e];
        }

        // acc += pv / sum(e); at the last head y = round(acc + c + x)
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const int col = hf * (H / 2) + i * 8 + 2 * t4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + g4 + 8 * r;
            if (row < T) {
              float2 v = make_float2(o[i][2 * r] / lt[r], o[i][2 * r + 1] / lt[r]);
              float2* pa = reinterpret_cast<float2*>(acc + row * H + col);
              if (!first) {
                const float2 a = *pa;
                v = make_float2(a.x + v.x, a.y + v.y);
              }
              if (!last) {
                *pa = v;
              } else {
                const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xm + row * H + col);
                const float2 cc = *reinterpret_cast<const float2*>(cvec + col);
                *reinterpret_cast<__nv_bfloat162*>(ym + row * H + col) = __floats2bfloat162_rn(
                    (v.x + cc.x) + __bfloat162float(xv.x), (v.y + cc.y) + __bfloat162float(xv.y));
              }
            }
          }
        }
      }
    }
  }
}

size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// The workspace's parts, in bytes, in order: the bf16 weights and float32
// vectors of every head (as the prep kernel writes them), and each block's
// float32 head sum [TMAX][CH].
template <int CH>
struct Layout {
  size_t wts, vecs, acc, total;
  Layout(int nh, int nblocks) {
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
    wts = take(size_t(nh) * Width<CH>::WTS_PER_HEAD * 2);
    vecs = take(size_t(nh) * Width<CH>::VEC_PER_HEAD * 4);
    acc = take(size_t(nblocks) * TMAX * CH * 4);
    total = off;
  }
};

template <int CH>
int launch(const void* x, const void* ln, const void* A, const void* Wvo, const void* c, void* y,
           void* ws, int nblocks, int M, int T, int nh, float eps, cudaStream_t s) {
  const Layout<CH> L(nh, nblocks);
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* wts = reinterpret_cast<bf16*>(base + L.wts);
  float* vecs = reinterpret_cast<float*>(base + L.vecs);
  attention_block_tc_prep<CH><<<nh, 256, 0, s>>>(static_cast<const float*>(A),
                                                 static_cast<const float*>(Wvo), wts, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attention_block_tc_kernel<CH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Dims<CH>::SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  attention_block_tc_kernel<CH><<<nblocks, NT, Dims<CH>::SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln), wts, vecs,
      static_cast<const float*>(c), static_cast<bf16*>(y), reinterpret_cast<float*>(base + L.acc),
      M, T, nh, eps);
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of workspace the forward needs for nh heads and nblocks persistent blocks.
extern "C" long long nbss_attention_block_tc_workspace_bytes(int nh, int nblocks) {
  return static_cast<long long>(Layout<H>(nh, nblocks).total);
}

// x, y: [M, T, H] bfloat16, contiguous. ln [2, H], A and Wvo [nh, H+2, H+2],
// c [H]: float32, contiguous. ws: nbss_attention_block_tc_workspace_bytes
// bytes, 256-byte aligned, any content; nblocks (1 .. M) persistent blocks.
// Returns the CUDA error of the launches (0 on success); shapes the kernel
// is not built for return cudaErrorInvalidValue without launching.
extern "C" int nbss_attention_block_tc_fwd(const void* x, const void* ln, const void* A,
                                           const void* Wvo, const void* c, void* y, void* ws,
                                           int nblocks, int M, int T, int Hdim, int nh, float eps,
                                           void* stream) {
  if (Hdim != H || T < 1 || T > TMAX || M < 1 || nh < 1 || nblocks < 1 || nblocks > M ||
      (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  return launch<H>(x, ln, A, Wvo, c, y, ws, nblocks, M, T, nh, eps,
                   static_cast<cudaStream_t>(stream));
}
