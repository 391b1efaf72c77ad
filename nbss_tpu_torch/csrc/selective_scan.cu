// Selective state-space scan (Mamba v1), forward, for Hopper (sm_90a).
//
// For each of M independent sequences of T frames by D channels, with a
// float32 state of N values per channel,
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//     y_t = round(C_t . h_t) + D * x_t        (round: to x's type)
//
// x, B, C and y are float32 or bfloat16; dt, A and D are float32. The
// rounding of C . h before the D term is added is the Pallas kernel's (the
// JAX package trained its checkpoints through it). When hb is given, the
// state at the start of every CHUNK frames is written there, [n_chunks, M,
// N, D] float32, for selective_scan_bwd.cu to recompute each chunk from.
//
// Replaces the Pallas TPU kernel selective_scan_pallas / _pallas_scan_kernel
// in nbss_tpu/ops/ssm.py.
//
// What bounds it on an H100: memory traffic. At the serving shape (M = 2064,
// T = 251, D = 192, N = 16, bf16) one call reads x (199 MB), dt (398 MB, the
// float32 softplus island) and B, C (33 MB), and writes y (199 MB): about
// 0.25 ms at 3.35 TB/s, against about 11 GFLOP of float32 work (0.17 ms at
// 67 TFLOP/s). The design reads each input once and keeps the state in
// registers: one thread per (sequence, channel) holds its N states and walks
// T, so no [M, T, D, N] tensor ever exists. B_t and C_t are the same for
// every channel of a sequence, so a block (one sequence, 64 channels) stages
// them, with x and dt, through shared memory TS frames at a time; the reads
// of x[m, t, :] and dt[m, t, :] are coalesced in the [M, T, D] layout the
// model produces. N is padded to NMAX with A = B = C = 0, so the padded
// states stay 0. expf (not __expf): the state passes through T products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NMAX = 16;   // largest state size
constexpr int CHUNK = 8;   // frames between saved states (ops/ssm.py CHUNK)
constexpr int BD = 64;     // channels (threads) per block
constexpr int TS = 32;     // frames staged in shared memory at a time
static_assert(TS % CHUNK == 0, "a staged span starts on a chunk boundary");

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

template <typename E>
__global__ void __launch_bounds__(BD) selective_scan_kernel(
    const E* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const E* __restrict__ Bm, const E* __restrict__ Cm, const float* __restrict__ Dp,
    E* __restrict__ y, float* __restrict__ hb, int M, int T, int D, int N) {
  __shared__ float sx[TS][BD], sdt[TS][BD], sb[TS][NMAX], sc[TS][NMAX];
  const int ntiles = (D + BD - 1) / BD;
  const int m = blockIdx.x / ntiles;
  const int tid = threadIdx.x;
  const int d = (blockIdx.x % ntiles) * BD + tid;
  const bool live = d < D;

  float a[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a[n] = (live && n < N) ? A[size_t(d) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;
  const size_t row0 = size_t(m) * T;

  for (int t0 = 0; t0 < T; t0 += TS) {
    const int tc = min(TS, T - t0);
    __syncthreads();  // the previous span's shared values are consumed
    for (int i = tid; i < TS * NMAX; i += BD) {
      const int t = i / NMAX, n = i % NMAX;
      const bool ok = t < tc && n < N;
      const size_t off = (row0 + t0 + t) * N + n;
      sb[t][n] = ok ? Elem<E>::load(Bm + off) : 0.f;
      sc[t][n] = ok ? Elem<E>::load(Cm + off) : 0.f;
    }
#pragma unroll 8
    for (int t = 0; t < tc; ++t) {
      const size_t off = (row0 + t0 + t) * D + d;
      sx[t][tid] = live ? Elem<E>::load(x + off) : 0.f;
      sdt[t][tid] = live ? dt[off] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < tc; ++t) {
      const int tg = t0 + t;
      if (hb != nullptr && tg % CHUNK == 0) {
        float* dst = hb + (size_t(tg / CHUNK) * M + m) * N * D + d;
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < N) dst[size_t(n) * D] = h[n];
      }
      const float dtv = sdt[t][tid], xv = sx[t][tid], dbx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + dbx * sb[t][n];
        acc += h[n] * sc[t][n];
      }
      Elem<E>::store(y + (row0 + tg) * D + d, Elem<E>::round(acc) + xv * dd);
    }
  }
}

template <typename E>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dp, void* y, void* hb, int M, int T, int D, int N,
           cudaStream_t stream) {
  const long long blocks = (long long)M * ((D + BD - 1) / BD);
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  selective_scan_kernel<E><<<int(blocks), BD, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const E*>(Bm), static_cast<const E*>(Cm), static_cast<const float*>(Dp),
      static_cast<E*>(y), static_cast<float*>(hb), M, T, D, N);
  return int(cudaGetLastError());
}

}  // namespace

// y = scan(x, dt, A, B, C) + D x on `stream`; hb (may be null) receives the
// chunk-start states. x, B, C, y are bfloat16 when is_bf16, else float32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int nbss_selective_scan_fwd(const void* x, const void* dt, const void* A,
                                       const void* Bm, const void* Cm, const void* Dp,
                                       void* y, void* hb, int M, int T, int D, int N,
                                       int is_bf16, void* stream) {
  if (M < 1 || T < 1 || D < 1 || N < 1 || N > NMAX) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, y, hb, M, T, D, N, s)
                 : launch<float>(x, dt, A, Bm, Cm, Dp, y, hb, M, T, D, N, s);
}

extern "C" int nbss_selective_scan_chunk() { return CHUNK; }
