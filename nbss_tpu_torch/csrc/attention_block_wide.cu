// Narrow-band attention block, forward and backward, float32, for the shapes
// attention_block.cu and attention_block_bwd.cu cannot hold: H = 192 at any
// T, and H = 96 at T > 256. fp32 FMA on the CUDA cores, since no tensor-core
// product keeps float32's digits; bf16 inputs at these shapes take
// attention_block_wide_tc.cu.
//
// Replaces, for float32 inputs, the Pallas TPU kernels _fused_block /
// _kernel and _fused_block_bwd / _bwd_kernel in
// nbss_tpu/ops/attention_block.py. It computes ops/attention_block.py
// reference and reference_bwd (whose roundings are the identity in float32),
// with the ragged key edge masked by sequence length instead of the pad lane.
//
// What bounds it on an H100: float32 arithmetic. At SpatialNet-large's
// serving shape (M = 2064, T = 251, H = 192, 4 heads) the folded forward is
// about 1.1 TFLOP of FMA, 17 ms at the card's 67 TFLOP/s. This is the simple
// route that float32 needs to be right at these shapes (the 50 dB checks and
// the gradient checks of the float32 kernel path): the block as a sequence of
// products and row passes over chunks of sequences, with the [T, T] scores of
// a chunk in a float32 workspace. Each product is wide_gemm, a tiled float32
// product over strided, batched operands; the row passes are a warp a row.
//
//   forward, per chunk and head:
//     t = xa A_h, vo = xa Wvo_h[:, :H]          (xa = [LN(x), 1, 0], [rows, H+2])
//     S = t[:, :H+1] xa[:, :H+1]^T               (a batch of sequences)
//     e = exp(S - rowmax S), l = rowsum e        (wide_softmax, in place)
//     o = e vo;  acc (+)= o / l;  last head: y = (acc + c) + x
//   backward, per chunk and head, after the same t, vo, S, e:
//     g' = g / l;  dvo = e^T g';  dP = g' vo^T
//     delta = rowsum(dP e) / l;  dS = e (dP - delta)   (in place)
//     dt = dS xa;  dxa += dS^T t[:, :H] + dt A_h^T + dvo Wvo_h^T
//     dA_h += xa^T dt, dWvo_h += xa^T dvo        (split over the rows, partials
//                                                added in order)
//   then the LayerNorm adjoint: dx, dln and dc.
//
// Every sum runs in a fixed order and no atomic is used: two launches give
// the same bits. H = 96 or 192; any nh that divides H, T >= 1 and M >= 1.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, GT = 256;  // wide_gemm's tiles and threads
constexpr int RT = 256;                              // threads of the row kernels
constexpr int NSPLIT = 64;                           // row slices of the weight products

size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[z][m][n] (+)= sum_k A[z][m][k] B[z][k][n], each operand addressed by its
// strides; batch z in blockIdx.z. With ktot > 0 the batch is a slice of one
// longer product: batch z takes k in [z K, min((z + 1) K, ktot)).
struct Gemm {
  const float* a;
  long long sam, sak, sab;
  const float* b;
  long long sbk, sbn, sbb;
  float* c;
  long long scm, scn, scb;
  int M, N, K;
  long long ktot;
  int accumulate;
};

__global__ void __launch_bounds__(GT) wide_gemm(const Gemm g) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const float* A = g.a + z * g.sab;
  const float* B = g.b + z * g.sbb;
  float* C = g.c + z * g.scb;
  const long long left = g.ktot - z * g.K;
  const int K = g.ktot > 0 && left < g.K ? int(left) : g.K;
  const bool a_k_fast = g.sak == 1, b_n_fast = g.sbn == 1;  // which index runs along memory
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < BM * BK / GT; ++l) {
      const int e = tid + l * GT;
      const int m = a_k_fast ? e / BK : e % BM, k = a_k_fast ? e % BK : e / BM;
      const int gm = m0 + m, gk = k0 + k;
      as[k][m] = gm < g.M && gk < K ? A[gm * g.sam + gk * g.sak] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < BN * BK / GT; ++l) {
      const int e = tid + l * GT;
      const int n = b_n_fast ? e % BN : e / BK, k = b_n_fast ? e / BN : e % BK;
      const int gn = n0 + n, gk = k0 + k;
      bs[k][n] = gn < g.N && gk < K ? B[gk * g.sbk + gn * g.sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      float* p = C + m * g.scm + n * g.scn;
      *p = g.accumulate ? *p + acc[i][j] : acc[i][j];
    }
  }
}

int gemm(cudaStream_t s, const float* a, long long sam, long long sak, long long sab,
         const float* b, long long sbk, long long sbn, long long sbb, float* c, long long scm,
         long long scn, long long scb, int M, int N, int K, int batch, bool accumulate,
         long long ktot = 0) {
  const Gemm g{a, sam, sak, sab, b, sbk, sbn, sbb, c, scm, scn, scb, M, N, K, ktot, accumulate};
  wide_gemm<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM, batch), GT, 0, s>>>(g);
  return int(cudaGetLastError());
}

// xa[r] = [LN(x[r]), 1, 0] (H + 2 wide), a warp a row
__global__ void __launch_bounds__(RT) wide_ln(const float* __restrict__ x,
                                              const float* __restrict__ ln,
                                              float* __restrict__ xa, int rows, int H, float eps) {
  const int r = (blockIdx.x * RT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* xr = x + size_t(r) * H;
  float s = 0.f;
  for (int k = lane; k < H; k += 32) s += xr[k];
  const float mu = warp_sum(s) / float(H);
  float q = 0.f;
  for (int k = lane; k < H; k += 32) q = fmaf(xr[k] - mu, xr[k] - mu, q);
  const float rs = rsqrtf(warp_sum(q) / float(H) + eps);
  float* o = xa + size_t(r) * (H + 2);
  for (int k = lane; k < H; k += 32) o[k] = (xr[k] - mu) * rs * ln[k] + ln[H + k];
  if (lane < 2) o[H + lane] = lane == 0 ? 1.f : 0.f;
}

// Per row of S [rows, T]: e = exp(s - max) in place, l = sum e; with g
// given, also g'[r] = g[r] / l (H wide).
__global__ void __launch_bounds__(RT) wide_softmax(float* __restrict__ S, float* __restrict__ l,
                                                   const float* __restrict__ g,
                                                   float* __restrict__ gp, int rows, int T, int H) {
  const int r = (blockIdx.x * RT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  float* sr = S + size_t(r) * T;
  float mx = -INFINITY;
  for (int j = lane; j < T; j += 32) mx = fmaxf(mx, sr[j]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < T; j += 32) {
    const float e = expf(sr[j] - mx);
    sr[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) l[r] = sum;
  if (g) {
    const float rinv = 1.f / sum;
    for (int k = lane; k < H; k += 32) gp[size_t(r) * H + k] = g[size_t(r) * H + k] * rinv;
  }
}

// dS = e (dP - delta) in place over dP, delta = sum(dP e) / l, a warp a row
__global__ void __launch_bounds__(RT) wide_ds(const float* __restrict__ E, float* __restrict__ DP,
                                              const float* __restrict__ l, int rows, int T) {
  const int r = (blockIdx.x * RT + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* er = E + size_t(r) * T;
  float* dr = DP + size_t(r) * T;
  float s = 0.f;
  for (int j = lane; j < T; j += 32) s = fmaf(dr[j], er[j], s);
  const float delta = warp_sum(s) * (1.f / l[r]);
  for (int j = lane; j < T; j += 32) dr[j] = er[j] * (dr[j] - delta);
}

// acc (+)= o / l; at the last head y = (acc + c) + x
__global__ void __launch_bounds__(RT) wide_accumulate(const float* __restrict__ o,
                                                      const float* __restrict__ l,
                                                      float* __restrict__ acc,
                                                      const float* __restrict__ c,
                                                      const float* __restrict__ x,
                                                      float* __restrict__ y, long long n, int H,
                                                      int first, int last) {
  const long long i = (long long)blockIdx.x * RT + threadIdx.x;
  if (i >= n) return;
  const float v = o[i] / l[i / H] + (first ? 0.f : acc[i]);
  if (last)
    y[i] = (v + c[i % H]) + x[i];
  else
    acc[i] = v;
}

// LayerNorm adjoint, a warp a row: dx = g + rsig (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)); part[warp][3H] sums dxa xhat, dxa and g over the rows
// the warp takes (a fixed assignment, so the sums' order is fixed).
__global__ void __launch_bounds__(RT) wide_ln_bwd(const float* __restrict__ x,
                                                  const float* __restrict__ g,
                                                  const float* __restrict__ ln,
                                                  const float* __restrict__ dxa,
                                                  float* __restrict__ dx, float* __restrict__ part,
                                                  int rows, int H, float eps) {
  const int lane = threadIdx.x % 32;
  const int w = (blockIdx.x * RT + threadIdx.x) / 32, nw = gridDim.x * RT / 32;
  float* pw = part + size_t(w) * 3 * H;
  for (int k = lane; k < 3 * H; k += 32) pw[k] = 0.f;
  for (int r = w; r < rows; r += nw) {
    const float* xr = x + size_t(r) * H;
    const float* dr = dxa + size_t(r) * H;
    float s = 0.f;
    for (int k = lane; k < H; k += 32) s += xr[k];
    const float mu = warp_sum(s) / float(H);
    float q = 0.f;
    for (int k = lane; k < H; k += 32) q = fmaf(xr[k] - mu, xr[k] - mu, q);
    const float rs = rsqrtf(warp_sum(q) / float(H) + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float xh = (xr[k] - mu) * rs, dxh = dr[k] * ln[k];
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
      pw[k] = fmaf(dr[k], xh, pw[k]);
      pw[H + k] += dr[k];
      pw[2 * H + k] += g[size_t(r) * H + k];
    }
    const float m1 = warp_sum(s1) / float(H), m2 = warp_sum(s2) / float(H);
    for (int k = lane; k < H; k += 32) {
      const float xh = (xr[k] - mu) * rs, dxh = dr[k] * ln[k];
      dx[size_t(r) * H + k] = g[size_t(r) * H + k] + rs * (dxh - m1 - xh * m2);
    }
  }
}

// dst[r][col] += sum_p src[p][r][col] over nparts partials, in order; n =
// rows x width elements
__global__ void wide_sum(const float* __restrict__ src, float* __restrict__ dst, int nparts,
                         long long stride, long long n, long long ld_src, long long ld_dst,
                         int width) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long r = i / width, col = i % width;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += src[p * stride + r * ld_src + col];
  dst[r * ld_dst + col] += s;
}

// The workspace, in floats, in order. rows = chunk T.
struct Layout {
  size_t xa, t, vo, S, o, acc, l, gp, dvo, dP, dt, dxa, wpart, part, total;
  Layout(int chunk, int T, int H, int bwd, int nwarps) {
    const size_t rows = size_t(chunk) * T, HA = H + 2;
    size_t off = 0;
    auto take = [&](size_t floats) { const size_t at = off; off += align256(floats * 4) / 4; return at; };
    xa = take(rows * HA);
    t = take(rows * HA);
    vo = take(rows * H);
    S = take(rows * T);
    l = take(rows);
    o = take(bwd ? 0 : rows * H);
    acc = take(bwd ? 0 : rows * H);
    gp = take(bwd ? rows * H : 0);
    dvo = take(bwd ? rows * H : 0);
    dP = take(bwd ? rows * T : 0);
    dt = take(bwd ? rows * HA : 0);
    dxa = take(bwd ? rows * H : 0);
    wpart = take(bwd ? size_t(NSPLIT) * HA * HA : 0);
    part = take(bwd ? size_t(nwarps) * 3 * H : 0);
    total = off * 4;
  }
};

// xa and, for head h, t and vo of the chunk's rows
int project(cudaStream_t s, const Layout& L, float* ws, const float* A, const float* Wvo,
            int rows, int H, int h) {
  const long long HA = H + 2;
  const float* Ah = A + h * HA * HA;
  const float* Wh = Wvo + h * HA * HA;
  int err = gemm(s, ws + L.xa, HA, 1, 0, Ah, HA, 1, 0, ws + L.t, HA, 1, 0, rows, int(HA), int(HA), 1,
                 false);
  if (err) return err;
  return gemm(s, ws + L.xa, HA, 1, 0, Wh, HA, 1, 0, ws + L.vo, H, 1, 0, rows, H, int(HA), 1, false);
}

// S = t[:, :H+1] xa[:, :H+1]^T per sequence, then e = exp(S - max) in place and l
int scores(cudaStream_t s, const Layout& L, float* ws, const float* g, int mc, int T, int H) {
  const long long HA = H + 2, rows = (long long)mc * T;
  int err = gemm(s, ws + L.t, HA, 1, T * HA, ws + L.xa, 1, HA, T * HA, ws + L.S, T, 1,
                 (long long)T * T, T, T, H + 1, mc, false);
  if (err) return err;
  wide_softmax<<<int((rows * 32 + RT - 1) / RT), RT, 0, s>>>(ws + L.S, ws + L.l, g,
                                                              g ? ws + L.gp : nullptr, int(rows), T, H);
  return int(cudaGetLastError());
}

// chunks whose rows index every launch's grid in range
bool chunk_ok(long long chunk, int T) { return chunk <= 65535 && chunk * T <= (1LL << 22); }

}  // namespace

// Bytes of workspace for chunks of `chunk` sequences of T frames (bwd: the
// backward's; nwarps: the LayerNorm adjoint's warps).
extern "C" long long nbss_attention_block_wide_workspace_bytes(int chunk, int T, int H, int bwd,
                                                              int nwarps) {
  return static_cast<long long>(Layout(chunk, T, H, bwd, nwarps).total);
}

// y = the folded attention block of x, float32, on `stream`. x, y [M, T, H];
// ln [2, H], A and Wvo [nh, H+2, H+2], c [H]; all float32, contiguous. ws:
// the workspace's bytes for (chunk, T, H, 0, 0). Returns the CUDA error of
// the launches (0 on success).
extern "C" int nbss_attention_block_wide_fwd(const void* x, const void* ln, const void* A,
                                             const void* Wvo, const void* c, void* y, void* ws,
                                             int M, int T, int H, int nh, int chunk, float eps,
                                             void* stream) {
  if (M < 1 || T < 1 || (H != 96 && H != 192) || nh < 1 || H % nh || chunk < 1 ||
      !chunk_ok(chunk, T))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  for (int m0 = 0; m0 < M; m0 += chunk) {
    const int mc = std::min(chunk, M - m0), rows = mc * T;
    const Layout L(mc, T, H, 0, 0);
    const float* xc = xf + size_t(m0) * T * H;
    wide_ln<<<(rows * 32 + RT - 1) / RT, RT, 0, s>>>(xc, static_cast<const float*>(ln), w + L.xa,
                                                     rows, H, eps);
    if (int err = int(cudaGetLastError())) return err;
    for (int h = 0; h < nh; ++h) {
      int err = project(s, L, w, static_cast<const float*>(A), static_cast<const float*>(Wvo), rows,
                        H, h);
      if (!err) err = scores(s, L, w, nullptr, mc, T, H);
      if (!err)  // o = e vo per sequence
        err = gemm(s, w + L.S, T, 1, (long long)T * T, w + L.vo, H, 1, (long long)T * H, w + L.o, H,
                   1, (long long)T * H, T, H, T, mc, false);
      if (err) return err;
      const long long n = (long long)rows * H;
      wide_accumulate<<<int((n + RT - 1) / RT), RT, 0, s>>>(
          w + L.o, w + L.l, w + L.acc, static_cast<const float*>(c), xc, yf + size_t(m0) * T * H, n,
          H, h == 0, h == nh - 1);
      if ((err = int(cudaGetLastError()))) return err;
    }
  }
  return 0;
}

// The adjoint, float32: x, g, dx [M, T, H]; ln, A, Wvo as the forward's; out
// [2 nh (H+2)^2 + 3H] = dA, dWvo, dln, dc one after another. ws: the
// workspace's bytes for (chunk, T, H, 1, nblocks * 8). Returns the CUDA error
// of the launches (0 on success).
extern "C" int nbss_attention_block_wide_bwd(const void* x, const void* ln, const void* A,
                                             const void* Wvo, const void* g, void* dx, void* out,
                                             void* ws, int M, int T, int H, int nh, int chunk,
                                             int nblocks, float eps, void* stream) {
  if (M < 1 || T < 1 || (H != 96 && H != 192) || nh < 1 || H % nh || chunk < 1 || nblocks < 1 ||
      !chunk_ok(chunk, T))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const float* Af = static_cast<const float*>(A);
  const float* Wf = static_cast<const float*>(Wvo);
  float* of = static_cast<float*>(out);
  const long long HA = H + 2, nW = (long long)nh * HA * HA;
  const int nwarps = nblocks * RT / 32;
  // every cotangent but dx is a sum over the chunks, in order; dWvo's columns
  // H and H+1 lead to no product and stay 0
  int err = int(cudaMemsetAsync(of, 0, (2 * nW + 3 * H) * 4, s));
  if (err) return err;
  for (int m0 = 0; m0 < M; m0 += chunk) {
    const int mc = std::min(chunk, M - m0), rows = mc * T;
    const Layout L(mc, T, H, 1, nwarps);
    const float* xc = static_cast<const float*>(x) + size_t(m0) * T * H;
    const float* gc = static_cast<const float*>(g) + size_t(m0) * T * H;
    wide_ln<<<(rows * 32 + RT - 1) / RT, RT, 0, s>>>(xc, static_cast<const float*>(ln), w + L.xa,
                                                     rows, H, eps);
    if ((err = int(cudaGetLastError()))) return err;
    for (int h = 0; h < nh; ++h) {
      const float* Ah = Af + h * HA * HA;
      const float* Wh = Wf + h * HA * HA;
      const long long TT = (long long)T * T, TH = (long long)T * H, TA = T * HA;
      if ((err = project(s, L, w, Af, Wf, rows, H, h))) return err;
      if ((err = scores(s, L, w, gc, mc, T, H))) return err;
      // dvo = e^T g' per sequence
      if ((err = gemm(s, w + L.S, 1, T, TT, w + L.gp, H, 1, TH, w + L.dvo, H, 1, TH, T, H, T, mc,
                      false)))
        return err;
      // dP = g' vo^T per sequence, then dS in place
      if ((err = gemm(s, w + L.gp, H, 1, TH, w + L.vo, 1, H, TH, w + L.dP, T, 1, TT, T, T, H, mc,
                      false)))
        return err;
      wide_ds<<<(rows * 32 + RT - 1) / RT, RT, 0, s>>>(w + L.S, w + L.dP, w + L.l, rows, T);
      if ((err = int(cudaGetLastError()))) return err;
      // dt = dS xa per sequence ([rows, H+2]; lane H+1 stays 0)
      if ((err = gemm(s, w + L.dP, T, 1, TT, w + L.xa, HA, 1, TA, w + L.dt, HA, 1, TA, T, int(HA), T,
                      mc, false)))
        return err;
      // dxa (+)= dS^T t[:, :H] per sequence, + dt A_h^T, + dvo Wvo_h^T
      if ((err = gemm(s, w + L.dP, 1, T, TT, w + L.t, HA, 1, TA, w + L.dxa, H, 1, TH, T, H, T, mc,
                      h > 0)))
        return err;
      if ((err = gemm(s, w + L.dt, HA, 1, 0, Ah, 1, HA, 0, w + L.dxa, H, 1, 0, rows, H, int(HA), 1,
                      true)))
        return err;
      if ((err = gemm(s, w + L.dvo, H, 1, 0, Wh, 1, HA, 0, w + L.dxa, H, 1, 0, rows, H, H, 1, true)))
        return err;
      // dA_h = xa^T dt and dWvo_h = xa^T dvo over NSPLIT slices of the rows, added in order
      const int per = (rows + NSPLIT - 1) / NSPLIT;
      const int nsl = (rows + per - 1) / per;
      for (int which = 0; which < 2; ++which) {
        const int N = which ? H : int(HA);
        const float* D = which ? w + L.dvo : w + L.dt;
        if ((err = gemm(s, w + L.xa, 1, HA, per * HA, D, N, 1, (long long)per * N, w + L.wpart, HA, 1,
                        HA * HA, int(HA), N, per, nsl, false, rows)))
          return err;
        const long long n = HA * N;
        wide_sum<<<int((n + 255) / 256), 256, 0, s>>>(w + L.wpart, of + which * nW + h * HA * HA, nsl,
                                                     HA * HA, n, HA, HA, N);
        if ((err = int(cudaGetLastError()))) return err;
      }
    }
    wide_ln_bwd<<<nblocks, RT, 0, s>>>(xc, gc, static_cast<const float*>(ln), w + L.dxa,
                                       static_cast<float*>(dx) + size_t(m0) * T * H, w + L.part, rows,
                                       H, eps);
    if ((err = int(cudaGetLastError()))) return err;
    wide_sum<<<int((3 * H + 255) / 256), 256, 0, s>>>(w + L.part, of + 2 * nW, nwarps, 3 * H, 3 * H,
                                                     0, 0, 3 * H);
    if ((err = int(cudaGetLastError()))) return err;
  }
  return 0;
}
