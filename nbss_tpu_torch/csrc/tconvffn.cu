// Temporal conv-FFN of the offline SpatialNet layer, forward, for Hopper
// (sm_90a), on float32 inputs: float32 products on the CUDA cores keep the
// digits the float32 bound needs. bf16 inputs take tconvffn_tc.cu (bf16
// tensor cores).
//
// Computes, for each of M independent sequences x[m] of T frames by H channels,
//
//     LN -> 1x1 up (H -> FF) -> SiLU -> gconv1 -> SiLU -> gconv2 -> GroupNorm
//        -> SiLU -> gconv3 -> SiLU -> 1x1 down (FF -> H)
//
// with grouped k=3 'same' convolutions along T (8 groups) and the GroupNorm's
// statistics over the whole sequence (valid frames x channels of the group).
// The caller adds the residual.
//
// Replaces the Pallas TPU kernel fused_tconvffn -> _fused_forward / _kernel in
// nbss_tpu/ops/tconvffn.py on float32 inputs, where each of its rounding
// points (to the input type) is exact: every product accumulates in float32
// before its bias is added; a conv is ((m0 + m1) + m2) + b over its taps;
// SiLU is a / (1 + exp(-a)); LN and GN take statistics with var = E[y^2] -
// E[y]^2, normalize, then scale and shift; frames outside [0, T) are zero
// after every SiLU.
//
// What bounds it on an H100: arithmetic. At the flagship's serving shape
// (M = 2064, T = 251, H = 96, FF = 192) it moves about 199 MB of x and y in
// bf16 (plus the conv2 workspace, 199 MB written and read once) but does
// about 81 GFLOP (up and down 19 each, three grouped convs 43). The Pallas
// kernel multiplies by block-diagonal dense [FF, FF] matrices, eight times
// that arithmetic; this kernel does each grouped conv directly (FF/8 inputs x
// 3 taps an output), as float32 FMA on the CUDA cores.
//
// Design. The GroupNorm's statistics span the whole sequence and sit between
// conv2 and everything after it, so the chain runs as two launches over
// (sequence, 32-frame tile) blocks:
//   front: LN -> up -> SiLU -> conv1 -> SiLU -> conv2 over the tile and a
//          2-frame halo each side, all in shared memory; writes conv2's
//          output to a workspace and per-(sequence, tile, group) sums of y
//          and y^2 over the tile's valid frames;
//   back:  adds a sequence's tile sums in tile order, then GN -> SiLU ->
//          conv3 (1-frame halo) -> SiLU -> down, and writes y.
// Every sum is taken in a fixed order (no atomics), so a relaunch gives the
// same bits. The 1x1 products stage 32-row chunks of their weight in shared
// memory; each warp owns rows, each lane columns (the rows' values are
// broadcast). In a conv each thread owns one output channel and 8
// consecutive frames, so its three taps share each loaded input row.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int G = 8;          // groups of the convs and of the GroupNorm
constexpr int TT = 32;        // frames of output per block
constexpr int RM = 8;         // consecutive frames per conv task
constexpr int KC = 32;        // weight rows per staged chunk of a 1x1 product
constexpr int RC = (TT + 2 + RM - 1) / RM * RM;  // conv1 rows (frames t0-1 ...), whole tasks
constexpr int RU = RC + 2;                       // LN / up rows (frames t0-2 ...)

template <int H, int FF>
struct Cfg {
  static constexpr int CPG = FF / G;                       // channels of a group
  static constexpr int NC_UP = (FF < 192 ? FF : 192) / 32; // columns per lane, up pass
  static constexpr int NC_DOWN = H / 32;                   // columns per lane, down
  static constexpr int NR_UP = (RU + NW - 1) / NW;          // rows per warp, up
  static constexpr int NR_DOWN = TT / NW;                   // rows per warp, down
  static constexpr int R_FLOATS = RU * H > RC * FF ? RU * H : RC * FF;  // LN rows, then conv1
  static constexpr int FRONT_FLOATS = RU * FF + R_FLOATS + KC * 32 * NC_UP;
  static constexpr int BACK_FLOATS = (TT + 2) * FF + TT * FF + KC * H + 2 * G;
  // the parameter buffer, in the order of ops/tconvffn.py PARAM_NAMES
  static constexpr int LN_S = 0, LN_B = H, W_UP = 2 * H, B_UP = W_UP + H * FF;
  static constexpr int W_C1 = B_UP + FF, B_C1 = W_C1 + 3 * CPG * FF;
  static constexpr int W_C2 = B_C1 + FF, B_C2 = W_C2 + 3 * CPG * FF;
  static constexpr int GN_S = B_C2 + FF, GN_B = GN_S + FF;
  static constexpr int W_C3 = GN_B + FF, B_C3 = W_C3 + 3 * CPG * FF;
  static constexpr int W_DOWN = B_C3 + FF, B_DOWN = W_DOWN + FF * H;
  static_assert(H % 32 == 0 && FF % (32 * NC_UP) == 0, "lanes own whole columns");
  static_assert(FF % G == 0 && H % KC == 0 && FF % KC == 0, "whole groups and chunks");
  static_assert(FRONT_FLOATS * 4 <= 232448 && BACK_FLOATS * 4 <= 232448, "over 227 KB");
  static_assert((TT / RM) * FF * 2 <= RU * FF, "conv2 sums fit in the up rows");
};

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float conv_out(float m0, float m1, float m2, float b) {
  return ((m0 + m1) + m2) + b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] = sum_k A[r_i][k] W[k][c_j] for rows r_i = warp + 8 i (rows past
// nrows repeat the last one) and columns c_j = c0 + lane + 32 j. A is in
// shared memory (lda a multiple of 4); W [K][N] in device memory goes through
// WS a chunk of KC rows at a time. Every thread of the block must call it.
template <int NR, int NC>
__device__ __forceinline__ void dense_product(const float* A, int lda, int nrows,
                                              const float* __restrict__ W, int K, int N, int c0,
                                              float* WS, float (&acc)[NR][NC]) {
  constexpr int NCOL = 32 * NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int e = threadIdx.x; e < KC * NCOL; e += NT) {
      const int kk = e / NCOL, cc = e - kk * NCOL;
      WS[e] = __ldg(W + size_t(k0 + kk) * N + c0 + cc);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = min(warp + NW * i, nrows - 1);
        a[i] = *reinterpret_cast<const float4*>(A + r * lda + k0 + kk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) b[j] = WS[(kk + q) * NCOL + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
}

// One conv task: output channel o at rows r0 .. r0+RM-1, whose taps read
// input rows r .. r+2 of In (ld FF); w is [3][CPG][FF]. acc[k][j] is tap k's
// product at row r0 + j, each kept apart for its own rounding.
template <int CPG, int FF>
__device__ __forceinline__ void conv_task(const float* In, const float* __restrict__ w, int o,
                                          int r0, float (&acc)[3][RM]) {
  const int base = (o / CPG) * CPG;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < RM; ++j) acc[k][j] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < CPG; ++i) {
    const float w0 = __ldg(w + i * FF + o);
    const float w1 = __ldg(w + (CPG + i) * FF + o);
    const float w2 = __ldg(w + (2 * CPG + i) * FF + o);
    float a[RM + 2];
#pragma unroll
    for (int j = 0; j < RM + 2; ++j) a[j] = In[(r0 + j) * FF + base + i];
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      acc[0][j] = fmaf(a[j], w0, acc[0][j]);
      acc[1][j] = fmaf(a[j + 1], w1, acc[1][j]);
      acc[2][j] = fmaf(a[j + 2], w2, acc[2][j]);
    }
  }
}

template <int H, int FF>
__global__ void __launch_bounds__(NT, 2)
tconvffn_front(const float* __restrict__ x, const float* __restrict__ P, float* __restrict__ ws,
               float* __restrict__ partials, int T, int ntiles, float eps) {
  using C = Cfg<H, FF>;
  constexpr int CPG = C::CPG;
  extern __shared__ float4 smem4[];
  float* U = reinterpret_cast<float*>(smem4);  // up rows r <-> frame t0 - 2 + r, ld FF
  float* R = U + RU * FF;                      // LN rows (ld H), then conv1 rows (ld FF)
  float* WS = R + C::R_FLOATS;
  const int m = blockIdx.x / ntiles, tile = blockIdx.x - m * ntiles, t0 = tile * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xm = x + size_t(m) * T * H;

  // LayerNorm of frames t0-2 .. t0+RU-3 (zero rows outside the sequence)
  for (int r = warp; r < RU; r += NW) {
    const int f = t0 - 2 + r;
    if (f >= 0 && f < T) {
      float v[H / 32], s = 0.0f, sq = 0.0f;
#pragma unroll
      for (int c = 0; c < H / 32; ++c) {
        v[c] = xm[size_t(f) * H + lane + 32 * c];
        s += v[c];
        sq += v[c] * v[c];
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      const float mu = s / float(H);
      const float rs = 1.0f / sqrtf(sq / float(H) - mu * mu + eps);
#pragma unroll
      for (int c = 0; c < H / 32; ++c) {
        const int h = lane + 32 * c;
        const float y = (v[c] - mu) * rs * P[C::LN_S + h];
        R[r * H + h] = y + P[C::LN_B + h];
      }
    } else {
#pragma unroll
      for (int c = 0; c < H / 32; ++c) R[r * H + lane + 32 * c] = 0.0f;
    }
  }
  __syncthreads();

  // up -> SiLU
  for (int c0 = 0; c0 < FF; c0 += 32 * C::NC_UP) {
    float acc[C::NR_UP][C::NC_UP];
    dense_product<C::NR_UP, C::NC_UP>(R, H, RU, P + C::W_UP, H, FF, c0, WS, acc);
#pragma unroll
    for (int i = 0; i < C::NR_UP; ++i) {
      const int r = warp + NW * i, f = t0 - 2 + r;
      if (r >= RU) continue;
      const bool valid = f >= 0 && f < T;
#pragma unroll
      for (int j = 0; j < C::NC_UP; ++j) {
        const int c = c0 + lane + 32 * j;
        const float v = silu(acc[i][j] + P[C::B_UP + c]);
        U[r * FF + c] = valid ? v : 0.0f;
      }
    }
  }
  __syncthreads();

  // conv1 -> SiLU, rows r <-> frame t0 - 1 + r, into R
  for (int task = threadIdx.x; task < (RC / RM) * FF; task += NT) {
    const int chunk = task / FF, o = task - chunk * FF, r0 = chunk * RM;
    float acc[3][RM];
    conv_task<CPG, FF>(U, P + C::W_C1, o, r0, acc);
    const float b = P[C::B_C1 + o];
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int f = t0 - 1 + r0 + j;
      const float v = silu(conv_out(acc[0][j], acc[1][j], acc[2][j], b));
      R[(r0 + j) * FF + o] = (f >= 0 && f < T) ? v : 0.0f;
    }
  }
  __syncthreads();

  // conv2, rows r <-> frame t0 + r: to the workspace, with its sums (in U)
  float* S = U;  // [TT / RM][FF][2]
  for (int task = threadIdx.x; task < (TT / RM) * FF; task += NT) {
    const int chunk = task / FF, o = task - chunk * FF, r0 = chunk * RM;
    float acc[3][RM];
    conv_task<CPG, FF>(R, P + C::W_C2, o, r0, acc);
    const float b = P[C::B_C2 + o];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int f = t0 + r0 + j;
      const float v = conv_out(acc[0][j], acc[1][j], acc[2][j], b);
      if (f < T) {
        ws[(size_t(m) * T + f) * FF + o] = v;
        s1 += v;
        s2 += v * v;
      }
    }
    S[(chunk * FF + o) * 2] = s1;
    S[(chunk * FF + o) * 2 + 1] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 2 * G) {
    const int g = threadIdx.x >> 1, which = threadIdx.x & 1;
    float s = 0.0f;
    for (int chunk = 0; chunk < TT / RM; ++chunk)
      for (int i = 0; i < CPG; ++i) s += S[(chunk * FF + g * CPG + i) * 2 + which];
    partials[((size_t(m) * ntiles + tile) * G + g) * 2 + which] = s;
  }
}

template <int H, int FF>
__global__ void __launch_bounds__(NT, 2)
tconvffn_back(const float* __restrict__ ws, const float* __restrict__ partials,
              const float* __restrict__ P, float* __restrict__ y, int T, int ntiles, float eps) {
  using C = Cfg<H, FF>;
  constexpr int CPG = C::CPG;
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // GN -> SiLU rows r <-> frame t0 - 1 + r
  float* C3 = A + (TT + 2) * FF;                // conv3 -> SiLU rows r <-> frame t0 + r
  float* WS = C3 + TT * FF;
  float* stat = WS + KC * H;                    // mean [G], 1 / std [G]
  const int m = blockIdx.x / ntiles, tile = blockIdx.x - m * ntiles, t0 = tile * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float s1 = 0.0f, s2 = 0.0f;
    for (int tl = 0; tl < ntiles; ++tl) {
      s1 += partials[((size_t(m) * ntiles + tl) * G + g) * 2];
      s2 += partials[((size_t(m) * ntiles + tl) * G + g) * 2 + 1];
    }
    const float denom = float(T * CPG);
    const float mu = s1 / denom;
    stat[g] = mu;
    stat[G + g] = 1.0f / sqrtf(s2 / denom - mu * mu + eps);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < (TT + 2) * FF; e += NT) {
    const int r = e / FF, o = e - r * FF, f = t0 - 1 + r;
    float a = 0.0f;
    if (f >= 0 && f < T) {
      const int g = o / CPG;
      const float v = ws[(size_t(m) * T + f) * FF + o];
      a = silu((v - stat[g]) * stat[G + g] * P[C::GN_S + o] + P[C::GN_B + o]);
    }
    A[e] = a;
  }
  __syncthreads();

  for (int task = threadIdx.x; task < (TT / RM) * FF; task += NT) {
    const int chunk = task / FF, o = task - chunk * FF, r0 = chunk * RM;
    float acc[3][RM];
    conv_task<CPG, FF>(A, P + C::W_C3, o, r0, acc);
    const float b = P[C::B_C3 + o];
#pragma unroll
    for (int j = 0; j < RM; ++j)
      C3[(r0 + j) * FF + o] = silu(conv_out(acc[0][j], acc[1][j], acc[2][j], b));
  }
  __syncthreads();

  float acc[C::NR_DOWN][C::NC_DOWN];
  dense_product<C::NR_DOWN, C::NC_DOWN>(C3, FF, TT, P + C::W_DOWN, FF, H, 0, WS, acc);
#pragma unroll
  for (int i = 0; i < C::NR_DOWN; ++i) {
    const int f = t0 + warp + NW * i;
    if (f >= T) continue;
#pragma unroll
    for (int j = 0; j < C::NC_DOWN; ++j) {
      const int h = lane + 32 * j;
      y[(size_t(m) * T + f) * H + h] = acc[i][j] + P[C::B_DOWN + h];
    }
  }
}

template <int H, int FF>
cudaError_t launch(const void* x, const void* params, void* y, void* ws, void* partials, int M,
                   int T, float eps, cudaStream_t s) {
  using C = Cfg<H, FF>;
  const int ntiles = (T + TT - 1) / TT;
  const long long blocks = (long long)M * ntiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t front_bytes = size_t(C::FRONT_FLOATS) * sizeof(float);
  const size_t back_bytes = size_t(C::BACK_FLOATS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tconvffn_front<H, FF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(front_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tconvffn_back<H, FF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(back_bytes));
  if (err != cudaSuccess) return err;
  const float* P = static_cast<const float*>(params);
  tconvffn_front<H, FF><<<unsigned(blocks), NT, front_bytes, s>>>(
      static_cast<const float*>(x), P, static_cast<float*>(ws), static_cast<float*>(partials), T,
      ntiles, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tconvffn_back<H, FF><<<unsigned(blocks), NT, back_bytes, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(partials), P,
      static_cast<float*>(y), T, ntiles, eps);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* params, void* y, void* ws, void* partials,
                     int M, int T, int H, int FF, float eps, cudaStream_t s) {
  if (H == 96 && FF == 192) return launch<96, 192>(x, params, y, ws, partials, M, T, eps, s);
  if (H == 192 && FF == 384) return launch<192, 384>(x, params, y, ws, partials, M, T, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y [M, T, H] and the workspace [M, T, FF] in float32 (bf16 inputs take
// tconvffn_tc.cu); params the float32 buffer of ops/tconvffn.py
// _kernel_operands(); partials [M, ceil(T / tile frames), 8, 2] float32.
// Two launches on stream.
extern "C" int nbss_tconvffn_fwd(const void* x, const void* params, void* y, void* ws,
                                 void* partials, int M, int T, int H, int FF, int groups,
                                 float eps, void* stream) {
  if (M < 1 || T < 1 || groups != G) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dispatch(x, params, y, ws, partials, M, T, H, FF, eps, s));
}

// Frames of output per block: the partial sums hold ceil(T / this) tiles.
extern "C" int nbss_tconvffn_tile_frames() { return TT; }
