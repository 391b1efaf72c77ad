// Temporal conv-FFN of the offline SpatialNet layer, forward, on Hopper's
// bf16 tensor cores (sm_90a, mma.sync). The bf16 counterpart of tconvffn.cu,
// which keeps the float32 inputs.
//
// For each of M independent sequences x[m] of T frames by H channels,
//
//     LN -> 1x1 up (H -> FF) -> SiLU -> gconv1 -> SiLU -> gconv2 -> GroupNorm
//        -> SiLU -> gconv3 -> SiLU -> 1x1 down (FF -> H)
//
// with grouped k=3 'same' convolutions along T (8 groups) and the GroupNorm's
// statistics over the whole sequence. The caller adds the residual.
//
// Replaces the Pallas TPU kernel fused_tconvffn -> _fused_forward / _kernel in
// nbss_tpu/ops/tconvffn.py for bf16 inputs, at its rounding points: every
// parameter is a bf16 value (the wrapper rounds them); LN and GN take
// float32 statistics (var = E[y^2] - E[y]^2), round the normalized value,
// then scale and shift in bf16; every product takes bf16 operands, sums in
// float32 and is rounded before its bias is added; a conv is
// rnd(rnd(rnd(m0 + m1) + m2) + b) over its taps, each tap's product kept in
// its own accumulator; SiLU is a / (1 + exp(-a)) in float32 of the rounded
// value, rounded once; frames outside [0, T) are zero after every SiLU. So
// mma.sync with bf16 operands and float32 accumulators forms the products
// that the Pallas dot_general(..., preferred_element_type=f32) forms; only
// the order of the float32 sums differs. SiLU takes ex2.approx and a fast
// division: its result is rounded to bf16 at once.
//
// What bounds it on an H100: the bound is the products' arithmetic. At the
// flagship's serving shape (M = 2064, T = 251, H = 96, FF = 192) x and y
// are 199 MB (59 us at 3.35 TB/s) and the products 81 GFLOP (82 us at 989
// TFLOP/s). But the products are small (K = 96 or 192; each group of a conv
// 24 inputs by 24 outputs), and between them every element of the [M, T,
// FF] activation (99.6 M) takes 27 roundings and four SiLUs on the CUDA
// cores, which take more instruction slots than the tensor cores take cycles.
//
// Design. One block of 8 warps a sequence walks it in steps of 64 frames,
// twice, keeping every activation in shared memory as bf16 rows (ldmatrix
// feeds the A fragments; a row stride 16 bytes past a multiple of 128 keeps
// it free of bank conflicts):
//   front walk, per step: LN of 64 frames -> up (a warp per 24 columns) ->
//     SiLU -> conv1 -> SiLU -> conv2 (a warp per group), each stage one frame
//     behind the one before, so the two frames a conv reads past the step
//     are carried from the step before and nothing is computed twice. conv2's
//     output goes to a workspace [M, T, FF] in bf16, and each warp keeps its
//     group's float32 sums of y and y^2 over the valid frames;
//   back walk, per step: GN of 64 frames from the workspace (statistics from
//     the warps' sums, no second pass over the data) -> SiLU -> conv3 ->
//     SiLU -> down, y written.
// The workspace is written and read by the same block within a few
// microseconds, so most of it stays in the 50 MB L2. Grouped convs run as
// one group's [16 x 24] x [24 x 24] products a tap (an m16n8k16 and an
// m16n8k8 step), never as the Pallas block-diagonal dense form (8x the
// arithmetic). Every B fragment comes straight from device memory (L1) in
// the fragment order the wrapper lays out (ops/tconvffn.py _tc_operands):
// one 4-byte load a register, 128 contiguous bytes a warp. Sums are taken in
// a fixed order (no atomics), so two launches give the same bits.

#include "mma_bf16.cuh"

namespace {

using namespace nbss_mma;

constexpr int NT = 256;      // threads a block
constexpr int NW = NT / 32;  // warps a block
constexpr int G = 8;         // groups of the convs and of the GroupNorm: a warp each
constexpr int TS = 64;       // frames a step of the walk
constexpr int MT = TS / 16;  // 16-row tiles a step
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NW == G, "a warp a group");

template <int H, int FF>
struct Cfg {
  static constexpr int CPG = FF / G;        // channels of a group
  static constexpr int LDX = H + 8;         // shared row strides in bf16 (16 bytes past a
  static constexpr int LDF = FF + 8;        //   multiple of 128: no ldmatrix bank conflicts)
  static constexpr int KBH = H / 8, KBF = FF / 8, KBC = CPG / 8;  // 8-deep k blocks
  static constexpr int NUP = FF / 8 / NW;   // up: n-tiles a warp
  static constexpr int MUP = NUP <= 3 ? 4 : 2;  // up: m-tiles a pass
  static constexpr int NDN = H / 8 / 4;     // down: n-tiles a warp (4 column sets x 2 row halves)
  static constexpr int NCV = CPG / 8;       // conv: n-tiles a warp
  static constexpr int MIN_BLOCKS = FF <= 192 ? 2 : 1;
  // the fragment buffer, in 32-bit words: each matrix [n-tile][k-block][lane]
  static constexpr int CONV_WORDS = 3 * G * NCV * KBC * 32;
  static constexpr int W_UP = 0;
  static constexpr int W_C1 = W_UP + KBF * KBH * 32;
  static constexpr int W_C2 = W_C1 + CONV_WORDS;
  static constexpr int W_C3 = W_C2 + CONV_WORDS;
  static constexpr int W_DOWN = W_C3 + CONV_WORDS;
  static constexpr int WORDS = W_DOWN + KBH * KBF * 32;
  // the vector buffer, in floats (the order of ops/tconvffn.py PARAM_NAMES)
  static constexpr int V_LN_S = 0, V_LN_B = H, V_B_UP = 2 * H, V_B_C1 = V_B_UP + FF,
                       V_B_C2 = V_B_C1 + FF, V_GN_S = V_B_C2 + FF, V_GN_B = V_GN_S + FF,
                       V_B_C3 = V_GN_B + FF, V_B_DOWN = V_B_C3 + FF, VECS = V_B_DOWN + H;
  // shared memory: X [TS][LDX], U and R [TS + 2][LDF] in bf16; the vectors; GN statistics
  static constexpr int X_ELEMS = TS * LDX, F_ELEMS = (TS + 2) * LDF;
  static constexpr int SMEM = (X_ELEMS + 2 * F_ELEMS) * 2 + (VECS + 2 * G) * 4;
  static_assert(H % 32 == 0 && CPG % 8 == 0 && FF % (8 * NW) == 0 && (H / 8) % 4 == 0,
                "whole warps, groups and tiles");
  static_assert((X_ELEMS * 2) % 16 == 0 && (F_ELEMS * 2) % 16 == 0, "16-byte aligned buffers");
  static_assert(SMEM <= 232448, "over 227 KB");
  static_assert(MT % MUP == 0, "whole passes");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two floats rounded to bf16 and back.
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// SiLU of a bf16 value in float32 (the caller rounds it).
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.0f + ex2(-LOG2E * v));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

// The conv's rounding over its taps for two neighbouring outputs:
// rnd(rnd(rnd(m0 + m1) + m2) + b), each m rounded first.
__device__ __forceinline__ float2 conv_out(const float (&m0)[2], const float (&m1)[2],
                                           const float (&m2)[2], float b0, float b1) {
  const float2 r0 = rnd2(m0[0], m0[1]), r1 = rnd2(m1[0], m1[1]), r2 = rnd2(m2[0], m2[1]);
  float2 v = rnd2(r0.x + r1.x, r0.y + r1.y);
  v = rnd2(v.x + r2.x, v.y + r2.y);
  return rnd2(v.x + b0, v.y + b1);
}

// One grouped k=3 conv over a step: output row j (0 .. TS-1) reads rows j,
// j+1, j+2 of In (frames f-1, f, f+1), this warp's group of channels. Wc is
// [tap][group][n-tile][k-block][lane]. epi(row, col, value pair) gets each
// pair of neighbouring outputs after the conv's rounding, bias included.
template <int H, int FF, typename Epi>
__device__ __forceinline__ void grouped_conv(const __nv_bfloat16* In,
                                             const uint32_t* __restrict__ Wc,
                                             const float* bias, int warp, int lane, Epi epi) {
  using C = Cfg<H, FF>;
  constexpr int NCV = C::NCV, KBC = C::KBC, K16 = C::CPG / 16;
  constexpr bool K8 = C::CPG % 16 != 0;  // a trailing m16n8k8 step
  constexpr int TAP = G * NCV * KBC * 32;
  const uint32_t* w = Wc + warp * NCV * KBC * 32 + lane;
  uint32_t b[3][NCV][KBC];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int n = 0; n < NCV; ++n)
#pragma unroll
      for (int kb = 0; kb < KBC; ++kb) b[k][n][kb] = __ldg(w + k * TAP + (n * KBC + kb) * 32);
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* in = In + (lane & 15) * C::LDF + C::CPG * warp;
#pragma unroll 1
  for (int mt = 0; mt < MT; ++mt) {
    float acc[3][NCV][4];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int n = 0; n < NCV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][n][e] = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const __nv_bfloat16* row = in + (16 * mt + k) * C::LDF;
#pragma unroll
      for (int ks = 0; ks < K16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, row + 16 * ks + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NCV; ++n) mma(acc[k][n], a, b[k][n][2 * ks], b[k][n][2 * ks + 1]);
      }
      if constexpr (K8) {
        uint32_t a[2];
        ldsm_x2(a, row + 16 * K16);
#pragma unroll
        for (int n = 0; n < NCV; ++n) mma_k8(acc[k][n], a, b[k][n][KBC - 1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NCV; ++n) {
      const int col = C::CPG * warp + 8 * n + 2 * t4;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m0[2] = {acc[0][n][2 * hh], acc[0][n][2 * hh + 1]};
        const float m1[2] = {acc[1][n][2 * hh], acc[1][n][2 * hh + 1]};
        const float m2[2] = {acc[2][n][2 * hh], acc[2][n][2 * hh + 1]};
        epi(16 * mt + g + 8 * hh, col, conv_out(m0, m1, m2, b0, b1));
      }
    }
  }
}

// Rows r0, r1 of a [rows][ld] bf16 buffer copied to rows 0, 1 (16-byte chunks).
template <int LD, int W>
__device__ __forceinline__ void carry_rows(__nv_bfloat16* buf, int r0, int tid) {
  constexpr int CH = W / 8;
  for (int i = tid; i < 2 * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    *reinterpret_cast<uint4*>(buf + r * LD + c) =
        *reinterpret_cast<const uint4*>(buf + (r0 + r) * LD + c);
  }
}

template <int H, int FF>
__global__ void __launch_bounds__(NT, Cfg<H, FF>::MIN_BLOCKS)
tconvffn_tc(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ W,
            const float* __restrict__ V, __nv_bfloat16* __restrict__ y, __nv_bfloat16* ws,
            int T, float eps) {
  using C = Cfg<H, FF>;
  constexpr int LDX = C::LDX, LDF = C::LDF, CPG = C::CPG;
  extern __shared__ uint4 smem[];
  __nv_bfloat16* X = reinterpret_cast<__nv_bfloat16*>(smem);  // LN rows <-> frames f0 ..
  __nv_bfloat16* U = X + C::X_ELEMS;  // front: up rows, row r <-> frame f0 - 2 + r; back: GN
  __nv_bfloat16* R = U + C::F_ELEMS;  // front: conv1 rows, r <-> f0 - 3 + r; back: conv3
  float* vec = reinterpret_cast<float*>(R + C::F_ELEMS);
  float* stat = vec + C::VECS;  // GN mean [G], 1 / std [G]
  const int m = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* xm = x + size_t(m) * T * H;
  __nv_bfloat16* wsm = ws + size_t(m) * T * FF;
  __nv_bfloat16* ym = y + size_t(m) * T * H;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < C::VECS; i += NT) vec[i] = V[i];
  for (int i = tid; i < 2 * LDF; i += NT) U[i] = R[i] = zero;  // frames before the sequence
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;  // this lane's share of its warp's group sums of y and y^2
  const int nfront = (T + 2 + TS - 1) / TS;
  for (int s = 0; s < nfront; ++s) {
    const int f0 = s * TS;
    if (s > 0) carry_rows<LDF, FF>(R, TS, tid);  // frames f0 - 3, f0 - 2

    // LayerNorm of frames f0 .. f0 + TS - 1, a warp per row (zero past T)
    {
      constexpr int RW = TS / NW, NC = H / 32;
      float v[RW][NC];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int f = f0 + warp + NW * i;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          v[i][c] = f < T ? __bfloat162float(xm[size_t(f) * H + lane + 32 * c]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = warp + NW * i;
        float sum = 0.f, sq = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          sum += v[i][c];
          sq += v[i][c] * v[i][c];
        }
        sum = warp_sum(sum);
        sq = warp_sum(sq);
        const float mu = sum / float(H);
        const float rs = 1.0f / sqrtf(sq / float(H) - mu * mu + eps);
        const bool valid = f0 + r < T;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int h = lane + 32 * c;
          float z = round_bf16((v[i][c] - mu) * rs);
          z = round_bf16(z * vec[C::V_LN_S + h]);
          X[r * LDX + h] = __float2bfloat16(valid ? z + vec[C::V_LN_B + h] : 0.f);
        }
      }
    }
    __syncthreads();

    // up -> SiLU into U rows 2 .. TS + 1: a warp per NUP n-tiles (its group's columns)
#pragma unroll 1
    for (int p = 0; p < MT / C::MUP; ++p) {
      float acc[C::MUP][C::NUP][4];
#pragma unroll
      for (int i = 0; i < C::MUP; ++i)
#pragma unroll
        for (int n = 0; n < C::NUP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
      const uint32_t* w = W + C::W_UP + (C::NUP * warp) * C::KBH * 32 + lane;
#pragma unroll 2
      for (int ks = 0; ks < H / 16; ++ks) {
        uint32_t b[C::NUP][2];
#pragma unroll
        for (int n = 0; n < C::NUP; ++n) {
          b[n][0] = __ldg(w + (n * C::KBH + 2 * ks) * 32);
          b[n][1] = __ldg(w + (n * C::KBH + 2 * ks + 1) * 32);
        }
#pragma unroll
        for (int i = 0; i < C::MUP; ++i) {
          uint32_t a[4];
          ldsm_x4(a, X + (16 * (p * C::MUP + i) + (lane & 15)) * LDX + 16 * ks + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < C::NUP; ++n) mma(acc[i][n], a, b[n][0], b[n][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < C::MUP; ++i)
#pragma unroll
        for (int n = 0; n < C::NUP; ++n) {
          const int col = 8 * (C::NUP * warp + n) + 2 * t4;
          const float b0 = vec[C::V_B_UP + col], b1 = vec[C::V_B_UP + col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * (p * C::MUP + i) + g + 8 * hh;
            float2 v = rnd2(acc[i][n][2 * hh], acc[i][n][2 * hh + 1]);
            v = rnd2(v.x + b0, v.y + b1);
            const bool valid = f0 + r < T;
            store2(U + (r + 2) * LDF + col, valid ? silu(v.x) : 0.f, valid ? silu(v.y) : 0.f);
          }
        }
    }
    __syncthreads();

    // conv1 -> SiLU: output row j <-> frame f0 - 1 + j, into R row j + 2
    grouped_conv<H, FF>(U, W + C::W_C1, vec + C::V_B_C1, warp, lane,
                        [&](int j, int col, float2 v) {
                          const int f = f0 - 1 + j;
                          const bool valid = f >= 0 && f < T;
                          store2(R + (j + 2) * LDF + col, valid ? silu(v.x) : 0.f,
                                 valid ? silu(v.y) : 0.f);
                        });
    __syncthreads();

    // conv2: output row j <-> frame f0 - 2 + j, to the workspace, with the GN sums
    carry_rows<LDF, FF>(U, TS, tid);  // frames f0 + TS - 2, f0 + TS - 1: U is read no more
    grouped_conv<H, FF>(R, W + C::W_C2, vec + C::V_B_C2, warp, lane,
                        [&](int j, int col, float2 v) {
                          const int f = f0 - 2 + j;
                          if (f >= 0 && f < T) {
                            store2(wsm + size_t(f) * FF + col, v.x, v.y);
                            s1 += v.x + v.y;
                            s2 += v.x * v.x + v.y * v.y;
                          }
                        });
    __syncthreads();
  }

  // GroupNorm statistics: warp w holds group w's sums
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float denom = float(T) * float(CPG);
    const float mu = s1 / denom;
    stat[warp] = mu;
    stat[G + warp] = 1.0f / sqrtf(s2 / denom - mu * mu + eps);
  }
  for (int i = tid; i < 2 * LDF; i += NT) U[i] = zero;  // frames before the sequence
  __syncthreads();  // also makes this block's workspace rows visible to all its threads

  const int nback = (T + 1 + TS - 1) / TS;
  for (int s = 0; s < nback; ++s) {
    const int f0 = s * TS;

    // GN -> SiLU of frames f0 .. f0 + TS - 1 into U rows 2 .. TS + 1, 8 channels a thread
    {
      constexpr int CH = FF / 8, IT = TS * CH / NT;
      static_assert(IT * NT == TS * CH, "whole rounds");
      uint4 raw[IT];
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int e = tid + i * NT, r = e / CH, c = (e - r * CH) * 8;
        raw[i] = f0 + r < T ? *reinterpret_cast<const uint4*>(wsm + size_t(f0 + r) * FF + c)
                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int e = tid + i * NT, r = e / CH, c = (e - r * CH) * 8;
        const int grp = c / CPG;
        const float mu = stat[grp], rs = stat[G + grp];
        const bool valid = f0 + r < T;
        uint32_t out[4];
        const uint32_t* in = reinterpret_cast<const uint32_t*>(&raw[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ch = c + 2 * q;
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[q]));
          float2 a = rnd2((v.x - mu) * rs, (v.y - mu) * rs);
          a = rnd2(a.x * vec[C::V_GN_S + ch], a.y * vec[C::V_GN_S + ch + 1]);
          a = rnd2(a.x + vec[C::V_GN_B + ch], a.y + vec[C::V_GN_B + ch + 1]);
          out[q] = valid ? pack(silu(a.x), silu(a.y)) : 0u;
        }
        *reinterpret_cast<uint4*>(U + (r + 2) * LDF + c) = make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // conv3 -> SiLU: output row j <-> frame f0 - 1 + j, into R row j
    grouped_conv<H, FF>(U, W + C::W_C3, vec + C::V_B_C3, warp, lane,
                        [&](int j, int col, float2 v) {
                          store2(R + j * LDF + col, silu(v.x), silu(v.y));
                        });
    __syncthreads();

    // down: a warp per (half of the rows, NDN n-tiles); y row j <-> frame f0 - 1 + j
    carry_rows<LDF, FF>(U, TS, tid);  // frames f0 + TS - 2, f0 + TS - 1
    {
      const int half = warp & 1, set = warp >> 1;
      float acc[2][C::NDN][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < C::NDN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
      const uint32_t* w = W + C::W_DOWN + (C::NDN * set) * C::KBF * 32 + lane;
#pragma unroll 2
      for (int ks = 0; ks < FF / 16; ++ks) {
        uint32_t b[C::NDN][2];
#pragma unroll
        for (int n = 0; n < C::NDN; ++n) {
          b[n][0] = __ldg(w + (n * C::KBF + 2 * ks) * 32);
          b[n][1] = __ldg(w + (n * C::KBF + 2 * ks + 1) * 32);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t a[4];
          ldsm_x4(a, R + (16 * (2 * half + i) + (lane & 15)) * LDF + 16 * ks + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < C::NDN; ++n) mma(acc[i][n], a, b[n][0], b[n][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < C::NDN; ++n) {
          const int col = 8 * (C::NDN * set + n) + 2 * t4;
          const float b0 = vec[C::V_B_DOWN + col], b1 = vec[C::V_B_DOWN + col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int f = f0 - 1 + 16 * (2 * half + i) + g + 8 * hh;
            if (f >= 0 && f < T) {
              float2 v = rnd2(acc[i][n][2 * hh], acc[i][n][2 * hh + 1]);
              store2(ym + size_t(f) * H + col, v.x + b0, v.y + b1);
            }
          }
        }
    }
    __syncthreads();
  }
}

template <int H, int FF>
cudaError_t launch(const void* x, const void* frags, const void* vecs, void* y, void* ws, int M,
                   int T, float eps, cudaStream_t s) {
  using C = Cfg<H, FF>;
  cudaError_t err = cudaFuncSetAttribute(tconvffn_tc<H, FF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  tconvffn_tc<H, FF><<<unsigned(M), NT, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(frags),
      static_cast<const float*>(vecs), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(ws), T, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y [M, T, H] and the workspace [M, T, FF] in bf16; frags the bf16 weight
// fragments and vecs the float32 vectors of ops/tconvffn.py _tc_operands().
// One launch on stream.
extern "C" int nbss_tconvffn_tc_fwd(const void* x, const void* frags, const void* vecs, void* y,
                                    void* ws, int M, int T, int H, int FF, int groups, float eps,
                                    void* stream) {
  if (M < 1 || T < 1 || groups != G) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 96 && FF == 192) return int(launch<96, 192>(x, frags, vecs, y, ws, M, T, eps, s));
  if (H == 192 && FF == 384) return int(launch<192, 384>(x, frags, vecs, y, ws, M, T, eps, s));
  return int(cudaErrorInvalidValue);
}

// 32-bit words of the fragment buffer for (H, FF), or -1 if not compiled.
extern "C" int nbss_tconvffn_tc_words(int H, int FF) {
  if (H == 96 && FF == 192) return Cfg<96, 192>::WORDS;
  if (H == 192 && FF == 384) return Cfg<192, 384>::WORDS;
  return -1;
}
