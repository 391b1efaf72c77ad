// Narrow-band attention block, backward, on Hopper's bf16 tensor cores
// (sm_90a, mma.sync). The bf16 counterpart of attention_block_bwd.cu, which
// keeps the float32 inputs.
//
// The adjoint of attention_block.cu: given x [M, T, H = 96] and the cotangent
// g of y = x + sum_h softmax(xa A_h xa^T) (xa Wvo_h)[:, :H] + c, with
// xa = [LN(x), 1, 0], it returns
//
//     dx   [M, T, H]        bf16,
//     dln  [2, H], dA, dWvo [nh, H+2, H+2], dc [1, H]   float32,
//
// recomputing the forward from (x, ln, A, Wvo). Replaces the Pallas TPU
// kernel _fused_block_bwd / _bwd_kernel in nbss_tpu/ops/attention_block.py
// for bf16 inputs, with its rounding points: t, vo, g' = g / rowsum(e), e
// where it meets g', dvo, dS and dt are rounded to bf16, exactly where they
// become mma operands; dP, delta, the e in dS, dxa and every weight
// cotangent stay float32.
//
// What bounds it on an H100: arithmetic, barely. At the training shape (M =
// 1032, T = 251, nh = 4) the unfolded backward is about 88 GFLOP (89 us at
// 989 TFLOP/s) and x, g, dx are 149 MB (45 us at 3.35 TB/s). The folded
// function computed here is about 2.4x the unfolded arithmetic, and its
// softmax adjoint needs several float32 operations per score on the CUDA
// cores.
//
// The lanes H and H+1 of xa are 1 and 0 for every frame, so each product
// runs over the 96 channels on mma.sync m16n8k16 (6 k-steps), and the ones
// lane enters as a float32 bias (t and vo start from row H of A and Wvo; the
// score adds t[:, H]; dt[:, H] is the row sum of dS). Per sequence, one block
// of 8 warps (a persistent grid over the sequences) keeps xa, and per head t,
// vo and g' of every frame in shared memory as bf16 (4 x 53 KB), and per
// head runs
//
//   P1 projections, a warp per 16-frame tile: t = xa A_h, vo = xa Wvo_h, with
//      A_h^T and Wvo_h^T staged in the (then free) g' tile.
//   P2 query pass, a warp per 16-query tile, the scores recomputed from t and
//      xa in 16-key tiles: the exact row max and sum(e); g' = g r; delta =
//      r sum(dP e); dS = e (dP - delta); dt = dS xa (the bf16 dS tile is the
//      A fragment of this product); the dt rows to global memory.
//   P3 key pass, a warp per 16-key tile, the transposed scores xa t^T
//      recomputed per 16-query tile: dvo = round(e)^T g', dxa_k += dS^T t,
//      with the transposed operands read by ldmatrix.trans; the dvo rows.
//   P5 dxa += dt A_h^T + dvo Wvo_h^T, a warp per 16-frame tile, from the dt
//      and dvo rows, with A_h and Wvo_h staged in the (then free) t tile.
//
// so no [T, T] matrix reaches memory of any kind. Each 16-frame tile belongs
// to the same warp in every pass, so each warp adds to its own rows of the
// sequence's float32 dxa (a per-block slot that stays in L2) with no
// barrier. Then the LayerNorm adjoint (P4) writes dx and sums dln, dc.
// The weight cotangents dA_h = xa^T dt and dWvo_h = xa^T dvo are products
// over every frame of every sequence: the main kernel writes xa, dt and dvo
// as bf16 rows, and a second kernel multiplies them on mma.sync over fixed
// slices of the rows, whose float32 partials a third kernel adds in a fixed
// order. No atomics anywhere: two launches give the same bits.
//
// What holds it back: the four [256, 96] bf16 tiles take 213 KB of shared
// memory, so an SM runs one block of 8 warps (241 registers a thread), too
// few to hide the latency of the score recomputations (three per query
// tile, one per key tile) and their exps. Reading the weights' B fragments
// from L2 in the passes instead of staging them cost 1.2 ms a call (4.5
// against 3.3 ms at the training shape on an H100).

#include "attention_block_tc.cuh"

namespace {

using namespace nbss_block;

constexpr int HW = 112;        // width of the xa and dt rows written for the weight products
constexpr int NW = 8;          // warps per block
constexpr int NT = NW * 32;
constexpr int TILE_BYTES = TMAX * LS * 2;

constexpr int SMEM_BYTES = 4 * TILE_BYTES + 3 * TMAX * 4;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
static_assert(NW * 3 * H * 4 <= TILE_BYTES, "the dln/dc reduction fits in a tile");

// The weight product (attention_block_bwd_weights): a block per (row slice,
// head, operand), 7 warps, each owning 16 output columns of a [112, 112]
// product, the rows staged 64 at a time.
constexpr int GROWS = 64;

struct Work {
  bf16* xa_rows;   // [M * T][HW]: xa of every frame (lane H = 1)
  bf16* dt_rows;   // [nh][M * T][HW]: dt (lane H = the row sum of dS)
  bf16* dvo_rows;  // [nh][M * T][H]
  float* dxa;      // [gridDim.x][TMAX][H], a block's dxa of its current sequence
  float* part;     // [gridDim.x][3H], a block's dln and dc
};

__global__ void __launch_bounds__(NT, 1)
attention_block_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln,
                              const bf16* __restrict__ wts, const float* __restrict__ vecs,
                              const bf16* __restrict__ g, bf16* __restrict__ dx, Work w, int M,
                              int T, int nh, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* XA = reinterpret_cast<bf16*>(smem_raw);  // [TMAX][LS] xa (lanes < H); rows >= T zero
  bf16* TS = XA + TMAX * LS;                      // [TMAX][LS] t of head h
  bf16* VO = TS + TMAX * LS;                      // [TMAX][LS] vo of head h
  bf16* GP = VO + TMAX * LS;                      // [TMAX][LS] g' of head h
  float* cs = reinterpret_cast<float*>(GP + TMAX * LS);  // [TMAX] t[:, H]
  float* ms = cs + TMAX;                                 // [TMAX] row max
  float* ds_ = ms + TMAX;                                // [TMAX] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int ntile = (T + 15) / 16;
  const size_t nrows = size_t(M) * T;
  float* dxa = w.dxa + size_t(blockIdx.x) * TMAX * H;

  float acc_dl0[3] = {0.f, 0.f, 0.f}, acc_dl1[3] = {0.f, 0.f, 0.f}, acc_dc[3] = {0.f, 0.f, 0.f};

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t row0 = size_t(m) * T;
    const bf16* xm = x + row0 * H;
    const bf16* gm = g + row0 * H;
    __syncthreads();  // the previous sequence is done with the tiles and dxa

    // P0. xa = round(LN(x)) of every frame, into XA and the xa rows; dxa = 0
    for (int j = warp; j < ntile * 16; j += NW) {
      bf16* row = XA + j * LS;
      if (j < T) {
        float v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = __bfloat162float(xm[j * H + lane + 32 * c]);
        const float mu = warp_sum(v[0] + v[1] + v[2]) / float(H);
        float d2 = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] -= mu;
          d2 = fmaf(v[c], v[c], d2);
        }
        const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
        bf16* out = w.xa_rows + (row0 + j) * HW;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = lane + 32 * c;
          const bf16 xv = __float2bfloat16(v[c] * rs * ln[k] + ln[H + k]);
          row[k] = xv;
          out[k] = xv;
          dxa[j * H + k] = 0.f;
        }
        if (lane < HW - H) out[H + lane] = __float2bfloat16(lane == 0 ? 1.f : 0.f);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) row[lane + 32 * c] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    for (int h = 0; h < nh; ++h) {
      const bf16* AT = wts + size_t(h) * WTS_PER_HEAD;
      const bf16* WT = AT + AT_N * H;
      const bf16* Ab = WT + H * H;
      const bf16* Wb = Ab + H * H;
      const float* abias = vecs + size_t(h) * VEC_PER_HEAD;
      const float* wbias = abias + AT_N;
      const float* acol = wbias + H;

      // P1. t = round(xa A_h) (and t[:, H] into cs), vo = round(xa Wvo_h), with A_h^T
      // and Wvo_h^T staged in the g' tile, which is free until P2
      bf16* ATs = GP;                 // [112][LS]: rows H + 2 .. 111 zero
      bf16* WTs = GP + 112 * LS;      // [H][LS]
      stage_weights(ATs, AT, AT_N, 112, tid, NT);
      stage_weights(WTs, WT, H, H, tid, NT);
      cp_async_wait_all();
      __syncthreads();
      for (int rt = warp; rt < ntile; rt += NW) {
        uint32_t F[KS][4];
        load_a(F, XA, rt * 16, lane);
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
          mma_rows<2>(c, F, ATs, n0 * 8, lane);
#pragma unroll
          for (int u = 0; u < 4; ++u) store(TS, c[u / 2][u % 2], abias, n0 + u);
          mma_rows<2>(c, F, WTs, n0 * 8, lane);
#pragma unroll
          for (int u = 0; u < 4; ++u) store(VO, c[u / 2][u % 2], wbias, n0 + u);
        }
        float c[1][2][4];
        mma_rows<1>(c, F, ATs, NC * 8, lane);  // columns H.. of t: t[:, H]
        if (t4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = rt * 16 + g4 + 8 * r;
            cs[i] = i < T ? round_bf16(c[0][0][2 * r] + abias[H]) : 0.f;
          }
        }
      }
      __syncthreads();

      // P2. query pass
      for (int qt = warp; qt < ntile; qt += NW) {
        const int q0 = qt * 16;
        uint32_t F[KS][4];
        load_a(F, TS, q0, lane);
        const float cq[2] = {cs[q0 + g4], cs[q0 + g4 + 8]};
        // the row max and sum(e), one key tile at a time (scoring two or four at once,
        // as independent accumulator chains, measured slower on an H100: 4.29 against
        // 3.31 ms a call at the training shape)
        float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        for (int kt = 0; kt < ntile; ++kt) {
          float s[2][4];
          score_tile(s, F, XA, kt, T, cq, lane);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float tm = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                   fmaxf(s[1][2 * r], s[1][2 * r + 1]));
            const float mn = fmaxf(mx[r], tm);
            if (mn == -INFINITY) continue;  // no key of this thread is valid yet
            float add = 0.f;
#pragma unroll
            for (int n = 0; n < 2; ++n)
              add += ex2((s[n][2 * r] - mn) * LOG2E) + ex2((s[n][2 * r + 1] - mn) * LOG2E);
            l[r] = l[r] * ex2((mx[r] - mn) * LOG2E) + add;
            mx[r] = mn;
          }
        }
        float rinv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const float mo = __shfl_xor_sync(0xffffffffu, mx[r], o);
            const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
            const float mn = fmaxf(mx[r], mo);
            l[r] = (mx[r] == mn ? l[r] : l[r] * ex2((mx[r] - mn) * LOG2E)) +
                   (mo == mn ? lo : lo * ex2((mo - mn) * LOG2E));
            mx[r] = mn;
          }
          rinv[r] = 1.f / l[r];
        }
        // g' = round(g r) for this tile's rows: the A fragments of dP = g' vo^T, and GP
        uint32_t G[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q & 1, i = q0 + g4 + 8 * r, col = ks * 16 + 2 * t4 + 8 * (q >> 1);
            uint32_t v = 0u;
            if (i < T) {
              const __nv_bfloat162 gv =
                  *reinterpret_cast<const __nv_bfloat162*>(gm + size_t(i) * H + col);
              v = pack(__bfloat162float(gv.x) * rinv[r], __bfloat162float(gv.y) * rinv[r]);
            }
            G[ks][q] = v;
            *reinterpret_cast<uint32_t*>(GP + i * LS + col) = v;
          }
        }
        // delta = r sum_j dP e
        float dsum[2] = {0.f, 0.f};
        for (int kt = 0; kt < ntile; ++kt) {
          float s[2][4], dp[1][2][4];
          score_tile(s, F, XA, kt, T, cq, lane);
          mma_rows<1>(dp, G, VO, kt * 16, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dsum[e >> 1] = fmaf(dp[0][n][e], ex2((s[n][e] - mx[e >> 1]) * LOG2E), dsum[e >> 1]);
        }
        float delta[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) delta[r] = quad_sum(dsum[r]) * rinv[r];
        // dS = round(e (dP - delta)); dt = dS xa, dt[:, H] = the row sum of dS
        float dt[NC][4] = {};
        float dsrow[2] = {0.f, 0.f};
        for (int kt = 0; kt < ntile; ++kt) {
          float s[2][4], dp[1][2][4];
          score_tile(s, F, XA, kt, T, cq, lane);
          mma_rows<1>(dp, G, VO, kt * 16, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = round_bf16(ex2((s[n][e] - mx[e >> 1]) * LOG2E) *
                                         (dp[0][n][e] - delta[e >> 1]));
              s[n][e] = d;
              dsrow[e >> 1] += d;
            }
          uint32_t P[4];
          pack_a(P, s[0], s[1]);
          mma_tile_t(dt, P, XA, kt * 16, lane);
        }
        float dtH[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) dtH[r] = round_bf16(quad_sum(dsrow[r]));
        if (t4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            ms[q0 + g4 + 8 * r] = mx[r];
            ds_[q0 + g4 + 8 * r] = q0 + g4 + 8 * r < T ? delta[r] : 0.f;
          }
        }
        // the dt rows (lane H: the row sum of dS)
        uint32_t D[KS][4];
        c_to_a(D, dt);
        bf16* out = w.dt_rows + (size_t(h) * nrows + row0) * HW;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = q0 + g4 + 8 * (q & 1);
            if (i < T) *reinterpret_cast<uint32_t*>(out + size_t(i) * HW + ks * 16 + 2 * t4 + 8 * (q >> 1)) = D[ks][q];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = q0 + g4 + 8 * r;
          if (i < T) {
            const bf16 z = __float2bfloat16(0.f);
            bf16* tail = out + size_t(i) * HW + H + 4 * t4;
            tail[0] = t4 == 0 ? __float2bfloat16(dtH[r]) : z;
            tail[1] = tail[2] = tail[3] = z;
          }
        }
      }
      __syncthreads();

      // P3. key pass
      for (int kt = warp; kt < ntile; kt += NW) {
        const int k0 = kt * 16;
        uint32_t FX[KS][4], FV[KS][4];
        load_a(FX, XA, k0, lane);
        load_a(FV, VO, k0, lane);
        float dvo[NC][4] = {}, dxk[NC][4] = {};
        for (int qt = 0; qt < ntile; ++qt) {
          const int q0 = qt * 16;
          float s[1][2][4], dp[1][2][4];
          mma_rows<1>(s, FX, TS, q0, lane);   // s^T: keys x queries
          mma_rows<1>(dp, FV, GP, q0, lane);  // dP^T = vo g'^T
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = q0 + n * 8 + 2 * t4 + c;
              const float cq = cs[i], mq = ms[i], dq = ds_[i];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int j = k0 + g4 + 8 * r;
                const float e = (i < T && j < T) ? ex2((s[0][n][2 * r + c] + cq - mq) * LOG2E)
                                                 : 0.f;
                s[0][n][2 * r + c] = e;
                dp[0][n][2 * r + c] = round_bf16(e * (dp[0][n][2 * r + c] - dq));
              }
            }
          }
          uint32_t P[4];
          pack_a(P, s[0][0], s[0][1]);   // round(e)^T
          mma_tile_t(dvo, P, GP, q0, lane);
          pack_a(P, dp[0][0], dp[0][1]);  // dS^T
          mma_tile_t(dxk, P, TS, q0, lane);
        }
        // the dvo rows, and dxa_k += dS^T t + dvo Wvo_h^T
        uint32_t D[KS][4];
        c_to_a(D, dvo);
        bf16* out = w.dvo_rows + (size_t(h) * nrows + row0) * H;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = k0 + g4 + 8 * (q & 1);
            if (j < T) *reinterpret_cast<uint32_t*>(out + size_t(j) * H + ks * 16 + 2 * t4 + 8 * (q >> 1)) = D[ks][q];
          }
        }
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + g4 + 8 * r;
            if (j < T) {
              float2* p = reinterpret_cast<float2*>(dxa + j * H + n * 8 + 2 * t4);
              float2 v = *p;
              v.x += dxk[n][2 * r];
              v.y += dxk[n][2 * r + 1];
              *p = v;
            }
          }
      }
      __syncthreads();

      // P5. dxa += dt A_h^T + dt[:, H] A_h[:H, H] + dvo Wvo_h^T, a warp per 16-frame tile,
      // from the dt and dvo rows this warp wrote, with A_h and Wvo_h staged in the t tile
      bf16* Abs = TS;            // [H][LS]
      bf16* Wbs = TS + H * LS;   // [H][LS]
      stage_weights(Abs, Ab, H, H, tid, NT);
      stage_weights(Wbs, Wb, H, H, tid, NT);
      cp_async_wait_all();
      __syncthreads();
      for (int rt = warp; rt < ntile; rt += NW) {
        const bf16* dtr = w.dt_rows + (size_t(h) * nrows + row0) * HW;
        const bf16* dvr = w.dvo_rows + (size_t(h) * nrows + row0) * H;
        uint32_t D[KS][4], V[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = rt * 16 + g4 + 8 * (q & 1), col = ks * 16 + 2 * t4 + 8 * (q >> 1);
            D[ks][q] = i < T ? *reinterpret_cast<const uint32_t*>(dtr + size_t(i) * HW + col) : 0u;
            V[ks][q] = i < T ? *reinterpret_cast<const uint32_t*>(dvr + size_t(i) * H + col) : 0u;
          }
        float dtH[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = rt * 16 + g4 + 8 * r;
          dtH[r] = i < T ? __bfloat162float(dtr[size_t(i) * HW + H]) : 0.f;
        }
        float c[NC / 2][2][4];
        mma_rows<NC / 2>(c, D, Abs, 0, lane);
        mma_rows<NC / 2, true>(c, V, Wbs, 0, lane);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float a0 = acol[n * 8 + 2 * t4], a1 = acol[n * 8 + 2 * t4 + 1];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = rt * 16 + g4 + 8 * r;
            if (i < T) {
              float2* p = reinterpret_cast<float2*>(dxa + i * H + n * 8 + 2 * t4);
              float2 v = *p;
              v.x += fmaf(dtH[r], a0, c[n / 2][n % 2][2 * r]);
              v.y += fmaf(dtH[r], a1, c[n / 2][n % 2][2 * r + 1]);
              *p = v;
            }
          }
        }
      }
      __syncthreads();  // the next head overwrites TS, VO, GP and the row statistics
    }

    // P4. LayerNorm adjoint: dx = g + rsig (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
    for (int j = warp; j < T; j += NW) {
      float v[3], gv[3], dl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = lane + 32 * c;
        v[c] = __bfloat162float(xm[j * H + k]);
        gv[c] = __bfloat162float(gm[j * H + k]);
        dl[c] = dxa[j * H + k];
      }
      const float mu = warp_sum(v[0] + v[1] + v[2]) / float(H);
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] -= mu;
        d2 = fmaf(v[c], v[c], d2);
      }
      const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
      float xhat[3], dxh[3], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = lane + 32 * c;
        xhat[c] = v[c] * rs;
        dxh[c] = dl[c] * ln[k];
        s1 += dxh[c];
        s2 = fmaf(dxh[c], xhat[c], s2);
        acc_dl0[c] = fmaf(dl[c], xhat[c], acc_dl0[c]);
        acc_dl1[c] += dl[c];
        acc_dc[c] += gv[c];
      }
      const float m1 = warp_sum(s1) / float(H), m2 = warp_sum(s2) / float(H);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dx[(row0 + j) * H + lane + 32 * c] = __float2bfloat16(gv[c] + rs * (dxh[c] - m1 - xhat[c] * m2));
    }
  }

  // the block's dln and dc: warps summed in a fixed order
  __syncthreads();
  float* red = reinterpret_cast<float*>(TS);  // [NW][3H]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = lane + 32 * c;
    red[warp * 3 * H + k] = acc_dl0[c];
    red[warp * 3 * H + H + k] = acc_dl1[c];
    red[warp * 3 * H + 2 * H + k] = acc_dc[c];
  }
  __syncthreads();
  for (int k = tid; k < 3 * H; k += NT) {
    float s = 0.f;
    for (int v = 0; v < NW; ++v) s += red[v * 3 * H + k];
    w.part[size_t(blockIdx.x) * 3 * H + k] = s;
  }
}

size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// The workspace's parts, in bytes, in order.
struct Layout {
  size_t wts, vecs, xa_rows, dt_rows, dvo_rows, dxa, part, wpart, total;
  Layout(int M, int T, int nh, int nblocks, int nslices) {
    const size_t nrows = size_t(M) * T;
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
    wts = take(size_t(nh) * WTS_PER_HEAD * 2);
    vecs = take(size_t(nh) * VEC_PER_HEAD * 4);
    xa_rows = take(nrows * HW * 2);
    dt_rows = take(size_t(nh) * nrows * HW * 2);
    dvo_rows = take(size_t(nh) * nrows * H * 2);
    dxa = take(size_t(nblocks) * TMAX * H * 4);
    part = take(size_t(nblocks) * 3 * H * 4);
    wpart = take(size_t(nslices) * 2 * nh * HW * HW * 4);
    total = off;
  }
};

}  // namespace

// Bytes of workspace the backward needs for these shapes, nblocks persistent
// blocks and nslices row slices of the weight products.
extern "C" long long nbss_attention_block_bwd_tc_workspace_bytes(int M, int T, int nh, int nblocks,
                                                                 int nslices) {
  return static_cast<long long>(Layout(M, T, nh, nblocks, nslices).total);
}

// x, g, dx: [M, T, H] bfloat16, contiguous. ln [2, H], A and Wvo [nh, H+2,
// H+2]: float32, contiguous. out: float32 [2 nh (H+2)^2 + 3H] = dA, dWvo,
// dln, dc one after another. ws: nbss_attention_block_bwd_tc_workspace_bytes
// bytes, 256-byte aligned, any content. Returns the CUDA error of the
// launches (0 on success); shapes the kernel is not built for return
// cudaErrorInvalidValue without launching.
extern "C" int nbss_attention_block_bwd_tc(const void* x, const void* ln, const void* A,
                                           const void* Wvo, const void* g, void* dx, void* out,
                                           void* ws, int nblocks, int nslices, int M, int T,
                                           int Hdim, int nh, float eps, void* stream) {
  if (Hdim != H || T < 1 || T > TMAX || M < 1 || nh < 1 || nblocks < 1 || nblocks > M ||
      nslices < 1 || (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L(M, T, nh, nblocks, nslices);
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* wts = reinterpret_cast<bf16*>(base + L.wts);
  float* vecs = reinterpret_cast<float*>(base + L.vecs);
  const Work w{reinterpret_cast<bf16*>(base + L.xa_rows), reinterpret_cast<bf16*>(base + L.dt_rows),
               reinterpret_cast<bf16*>(base + L.dvo_rows), reinterpret_cast<float*>(base + L.dxa),
               reinterpret_cast<float*>(base + L.part)};
  float* wpart = reinterpret_cast<float*>(base + L.wpart);

  attention_block_tc_prep<H><<<nh, 256, 0, s>>>(static_cast<const float*>(A),
                                                static_cast<const float*>(Wvo), wts, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attention_block_bwd_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return int(err);
  attention_block_bwd_tc_kernel<<<nblocks, NT, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln), wts, vecs,
      static_cast<const bf16*>(g), static_cast<bf16*>(dx), w, M, T, nh, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long nrows = (long long)M * T;
  const long long per = ((nrows + nslices - 1) / nslices + GROWS - 1) / GROWS * GROWS;
  attention_block_bwd_weights<H, HW, GROWS><<<dim3(nslices, 2 * nh), HW / 16 * 32, 0, s>>>(
      w.xa_rows, w.dt_rows, w.dvo_rows, wpart, nrows, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int n = int(2 * nh * HA * HA + 3 * H);
  attention_block_bwd_reduce<H, HW><<<(n + 255) / 256, 256, 0, s>>>(
      wpart, w.part, static_cast<float*>(out), nslices, nblocks, nh);
  return int(cudaGetLastError());
}
