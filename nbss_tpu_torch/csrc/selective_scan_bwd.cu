// Selective state-space scan (Mamba v1), backward, for Hopper (sm_90a).
//
// The reverse-time adjoint of selective_scan.cu, for a cotangent gy of y:
//
//     lam_t = exp(dt_{t+1} A) lam_{t+1} + gy_t C_t
//     gdt   = sum_n lam h_{t-1} exp(dt A) A + (lam . B_t) x_t
//     gx    = (lam . B_t) dt_t + gy D
//     gB    = sum_d lam dt x ;  gC = sum_d gy h_t
//     gA    = sum_{m,t} lam h_{t-1} exp(dt A) dt ;  gD = sum_{m,t} gy x
//
// all in float32; gx, gB and gC are written in x's type, gdt, gA and gD in
// float32. The states h come from the chunk-start states hb that the
// forward kernel wrote ([n_chunks, M, N, D] float32, one every CHUNK
// frames): each chunk is recomputed forward from its saved state, then
// walked backwards.
//
// Replaces the Pallas TPU kernel _pallas_scan_bwd / _pallas_scan_bwd_kernel
// in nbss_tpu/ops/ssm.py, together with the D terms its wrapper _ss_bwd adds.
//
// What bounds it on an H100: memory traffic. At the training shape (M =
// 1032, T = 251, D = 192, N = 16, bf16) a call reads x, gy (100 MB each),
// dt (199 MB), B, C (17 MB) and hb (406 MB), and writes gx (100 MB), gdt
// (199 MB) and gB, gC: about 0.34 ms at 3.35 TB/s, against about 13 GFLOP
// of float32 work. The design keeps every state-sized value out of device
// memory except hb: one thread per (sequence, channel) holds lam and its gA
// partial in registers, and the chunk's recomputed states in shared memory
// ([CHUNK][NMAX][64] floats a block). The sums over channels (gB, gC) are
// taken at each frame by a butterfly reduce-scatter inside each warp (32
// values, 31 shuffles) and one add across the block's two warps; blocks
// that share a sequence (D > 64) leave float32 partials that a second kernel
// adds in a fixed order. The sums over sequences and frames (gA, gD) are
// per-thread float32 partials added over M by a third kernel in a fixed
// order. No atomics: two launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NMAX = 16;   // largest state size
constexpr int CHUNK = 8;   // frames between saved states (ops/ssm.py CHUNK)
constexpr int BD = 64;     // channels (threads) per block
constexpr int NW = BD / 32;
static_assert(2 * NMAX == 32, "one warp lane per reduced value (gB and gC)");

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

// Sum each of the 32 values v[0..31] over the warp's lanes; lane l gets the
// sum of v[l]. Each step hands half of the values still held to the partner
// lane and keeps the other half: 16 + 8 + 4 + 2 + 1 shuffles.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// One block per (sequence m, tile of 64 channels).
// pbc [ntiles][M][T][2N]: the tile's gB (q < N) and gC (q >= N) sums.
// pa [M][N][D], pd [M][D]: each thread's gA and gD sums over its frames.
template <typename E>
__global__ void __launch_bounds__(BD) selective_scan_bwd_kernel(
    const E* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const E* __restrict__ Bm, const E* __restrict__ Cm, const float* __restrict__ Dp,
    const float* __restrict__ hb, const E* __restrict__ gy, E* __restrict__ gx,
    float* __restrict__ gdt, float* __restrict__ pbc, float* __restrict__ pa,
    float* __restrict__ pd, int M, int T, int D, int N) {
  __shared__ float sh[CHUNK][NMAX][BD];  // state before each frame of the chunk
  __shared__ float sx[CHUNK][BD], sdt[CHUNK][BD], sgy[CHUNK][BD];
  __shared__ float sb[CHUNK][NMAX], sc[CHUNK][NMAX];
  __shared__ float sred[CHUNK][NW][32];
  const int ntiles = (D + BD - 1) / BD;
  const int m = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tile * BD + tid;
  const bool live = d < D;
  const int nchunks = (T + CHUNK - 1) / CHUNK;

  float a[NMAX], lam[NMAX], ga[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a[n] = (live && n < N) ? A[size_t(d) * N + n] : 0.f;
    lam[n] = 0.f;
    ga[n] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;
  float gd = 0.f;
  const size_t row0 = size_t(m) * T;

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * CHUNK, tc = min(CHUNK, T - t0);
    __syncthreads();  // the previous chunk's shared values are consumed
    for (int i = tid; i < CHUNK * NMAX; i += BD) {
      const int t = i / NMAX, n = i % NMAX;
      const bool ok = t < tc && n < N;
      const size_t off = (row0 + t0 + t) * N + n;
      sb[t][n] = ok ? Elem<E>::load(Bm + off) : 0.f;
      sc[t][n] = ok ? Elem<E>::load(Cm + off) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const bool ok = live && t < tc;
      const size_t off = (row0 + t0 + t) * D + d;
      sx[t][tid] = ok ? Elem<E>::load(x + off) : 0.f;
      sdt[t][tid] = ok ? dt[off] : 0.f;
      sgy[t][tid] = ok ? Elem<E>::load(gy + off) : 0.f;
    }
    __syncthreads();

    // recompute the chunk's states from its saved start state
    float h[NMAX];
    const float* src = hb + (size_t(c) * M + m) * N * D + d;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) h[n] = (live && n < N) ? src[size_t(n) * D] : 0.f;
    for (int t = 0; t < tc; ++t) {
      const float dtv = sdt[t][tid], dbx = dtv * sx[t][tid];
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        sh[t][n][tid] = h[n];
        h[n] = expf(dtv * a[n]) * h[n] + dbx * sb[t][n];
      }
    }

    // walk the chunk backwards; h holds the state after frame t
    for (int t = tc - 1; t >= 0; --t) {
      const float dtv = sdt[t][tid], xv = sx[t][tid], gyv = sgy[t][tid], dbx = dtv * xv;
      float v[32];
      float lamB = 0.f, sA = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        const float hprev = sh[t][n][tid];
        lam[n] += gyv * sc[t][n];
        const float dA = expf(dtv * a[n]);
        const float g = lam[n] * hprev * dA;
        lamB += lam[n] * sb[t][n];
        sA += g * a[n];
        ga[n] += g * dtv;
        v[n] = lam[n] * dbx;
        v[NMAX + n] = gyv * h[n];
        lam[n] *= dA;
        h[n] = hprev;
      }
      if (live) {
        const size_t off = (row0 + t0 + t) * D + d;
        gdt[off] = sA + lamB * xv;
        Elem<E>::store(gx + off, lamB * dtv + gyv * dd);
      }
      gd += gyv * xv;
      sred[t][warp][lane] = reduce_scatter32(v, lane);
    }
    __syncthreads();
    const int q2 = 2 * N;
    for (int i = tid; i < tc * q2; i += BD) {
      const int t = i / q2, q = i % q2;
      const int l = q < N ? q : NMAX + q - N;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sred[t][w][l];
      pbc[((size_t(tile) * M + m) * T + t0 + t) * q2 + q] = s;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) pa[(size_t(m) * N + n) * D + d] = ga[n];
    pd[size_t(m) * D + d] = gd;
  }
}

// gB, gC [M, T, N] in x's type: the tiles' partials added in tile order.
template <typename E>
__global__ void selective_scan_bwd_finish_bc(const float* __restrict__ pbc, E* __restrict__ gB,
                                             E* __restrict__ gC, int ntiles, long long MT,
                                             int N) {
  const long long q2 = 2LL * N, total = MT * q2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < ntiles; ++k) s += pbc[k * total + i];
    const long long row = i / q2;
    const int q = int(i % q2);
    if (q < N) Elem<E>::store(gB + row * N + q, s);
    else Elem<E>::store(gC + row * N + q - N, s);
  }
}

// gA [D, N] and gD [D]: the per-sequence partials added in sequence order.
__global__ void selective_scan_bwd_finish_ad(const float* __restrict__ pa,
                                             const float* __restrict__ pd,
                                             float* __restrict__ gA, float* __restrict__ gD,
                                             int M, int D, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < D * N) {
    const int n = i / D, d = i % D;
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += pa[(size_t(m) * N + n) * D + d];
    gA[size_t(d) * N + n] = s;
  } else if (i < D * N + D) {
    const int d = i - D * N;
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += pd[size_t(m) * D + d];
    gD[d] = s;
  }
}

long long workspace_floats(int M, int T, int D, int N) {
  const long long ntiles = (D + BD - 1) / BD;
  return ntiles * M * T * 2 * N + (long long)M * N * D + (long long)M * D;
}

template <typename E>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dp, const void* hb, const void* gy, void* gx, void* gdt, void* gA,
           void* gB, void* gC, void* gD, void* ws, int M, int T, int D, int N,
           cudaStream_t stream) {
  const int ntiles = (D + BD - 1) / BD;
  const long long blocks = (long long)M * ntiles;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  float* pbc = static_cast<float*>(ws);
  float* pa = pbc + (long long)ntiles * M * T * 2 * N;
  float* pd = pa + (long long)M * N * D;
  selective_scan_bwd_kernel<E><<<int(blocks), BD, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const E*>(Bm), static_cast<const E*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(hb), static_cast<const E*>(gy), static_cast<E*>(gx),
      static_cast<float*>(gdt), pbc, pa, pd, M, T, D, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long MT = (long long)M * T;
  const long long nbc = MT * 2 * N;
  const int grid_bc = int(nbc / 256 + 1 < 65536 ? nbc / 256 + 1 : 65536);
  selective_scan_bwd_finish_bc<E><<<grid_bc, 256, 0, stream>>>(pbc, static_cast<E*>(gB),
                                                   static_cast<E*>(gC), ntiles, MT, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  selective_scan_bwd_finish_ad<<<(D * N + D + 255) / 256, 256, 0, stream>>>(
      pa, pd, static_cast<float*>(gA), static_cast<float*>(gD), M, D, N);
  return int(cudaGetLastError());
}

}  // namespace

// Floats of device scratch nbss_selective_scan_bwd needs for these sizes.
extern "C" long long nbss_selective_scan_bwd_workspace_floats(int M, int T, int D, int N) {
  return workspace_floats(M, T, D, N);
}

// (gx, gdt, gA, gB, gC, gD) of the scan for the cotangent gy, on `stream`.
// hb: the chunk-start states from nbss_selective_scan_fwd on the same inputs.
// x, B, C, gy, gx, gB, gC are bfloat16 when is_bf16, else float32.
// Returns the first CUDA launch error (0 on success).
extern "C" int nbss_selective_scan_bwd(const void* x, const void* dt, const void* A,
                                       const void* Bm, const void* Cm, const void* Dp,
                                       const void* hb, const void* gy, void* gx, void* gdt,
                                       void* gA, void* gB, void* gC, void* gD, void* ws,
                                       int M, int T, int D, int N, int is_bf16,
                                       void* stream) {
  if (M < 1 || T < 1 || D < 1 || N < 1 || N > NMAX) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, hb, gy, gx, gdt, gA, gB, gC,
                                         gD, ws, M, T, D, N, s)
                 : launch<float>(x, dt, A, Bm, Cm, Dp, hb, gy, gx, gdt, gA, gB, gC, gD, ws,
                                 M, T, D, N, s);
}
