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
// (199 MB) and gB, gC: 1.14 GB, 0.34 ms at 3.35 TB/s, against about 17
// GFLOP of float32 work (0.26 ms at 67 TFLOP/s) and 0.8 G exps.
//
// The design keeps every state-sized value out of device memory except hb.
// Four threads share a (sequence, channel), each with four of its N <= 16
// states in registers: lam, its gA partial and the chunk's recomputed
// states ([CHUNK][4]). The factors exp(dt A) are formed again on the walk
// back, on the special-function unit (ex2.approx, faster than expf on an
// H100): kept from the recompute, they cost 32 more registers a thread, and
// the spills at two blocks an SM made the kernel slower. A block is 64
// channels of one sequence, 256 threads; the chunk's x, dt, gy, B and C pass
// through shared memory, double-buffered, the next chunk's (and its saved
// state) loaded into registers while the current one is walked. The sums over a channel's
// states (lam . B, the gdt term) take two shuffles each. The sums over
// channels (gB, gC) are reduced over the warp's eight channels at each frame
// by a reduce-scatter of eight values (seven shuffles), then over the
// block's eight warps once a chunk in shared memory; blocks that share a
// sequence (D > 64) leave float32 partials that a second kernel adds in a
// fixed order. The sums over sequences and frames (gA, gD) are per-thread
// float32 partials added over M by a third kernel in a fixed order. No
// atomics: two launches on the same inputs give the same bits.
//
// Any N. As in the forward, a state size above 16 runs in passes over groups
// of 16 states, one launch each: a state's adjoint lam and its gA, gB and gC
// terms involve only that state, so each pass walks its group as above and
// writes its own columns of the gB, gC partials and of gA's. The two sums
// over all states, lam . B and sum_n lam h exp(dt A) A, are carried from
// pass to pass in float32: lam . B in a scratch buffer [M, T, D], the gdt
// term in gdt itself. The last pass adds its own parts, forms gx = (lam . B)
// dt + gy D (rounded once to x's type) and gdt = (the sum) + (lam . B) x, in
// the order of the groups; the first pass alone adds up gD. The finishing
// kernels run once, over every state. The N <= 16 route is the single pass
// above, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NMAX = 16;   // states of one pass
constexpr int CHUNK = 8;   // frames between saved states (ops/ssm.py CHUNK)
constexpr int NS = 4;      // states a thread
constexpr int NG = NMAX / NS;  // threads a channel
constexpr int BD = 64;     // channels a block
constexpr int NT = BD * NG;    // threads a block
constexpr int NW = NT / 32;
constexpr int CW = 32 / NG;    // channels a warp
constexpr int PF = CHUNK * BD / NT;  // values of x, dt, gy a thread stages
static_assert(2 * NS == CW, "one reduced value (gB or gC of a state) a lane");
static_assert(PF * NT == CHUNK * BD && 2 * CHUNK * NMAX == NT, "the staging shares");

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

// Sum each of the 2 NS values v over the warp's CW lanes that share lane %
// NG (its CW channels); lane l gets the sum of v[l / NG]. Each step hands
// half of the values still held to the partner lane: NS + NS / 2 + ... + 1
// shuffles.
__device__ __forceinline__ float reduce_scatter(float (&v)[2 * NS], int lane) {
#pragma unroll
  for (int off = 16, cnt = NS; off >= NG; off >>= 1, cnt >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < cnt; ++i) {
      const float send = upper ? v[i] : v[i + cnt];
      const float keep = upper ? v[i + cnt] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// 2^x on the special-function unit: exp(dt A) as 2^(dt A log2(e)), with A
// log2(e) formed once. Its relative error (about 2^-22) is far inside the
// gradient bound even through T products of it in lam.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sum over a channel's NG threads (lanes NG c .. NG c + NG - 1).
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int o = 1; o < NG; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// What a launch does with the sums over states: ONLY for N <= 16 (gx and
// gdt whole); for a pass over states n0 .. n0 + 15 of a larger N, FIRST
// writes its parts of lam . B (to lb) and of the gdt sum (to gdt), MID adds
// them there, LAST adds its own and forms gx and gdt.
enum Pass { ONLY, FIRST, MID, LAST };

// One block per (sequence m, tile of 64 channels); thread (channel c, group
// s) holds states n0 + 4s .. n0 + 4s + 3 of channel c.
// pbc [ntiles][M][T][2N]: the tile's gB (q < N) and gC (q >= N) sums.
// pa [M][N][D], pd [M][D]: each thread's gA and gD sums over its frames.
// lb [M][T][D]: lam . B of the earlier passes (N > 16).
template <typename E, Pass PASS>
__global__ void __launch_bounds__(NT, 2) selective_scan_bwd_kernel(
    const E* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const E* __restrict__ Bm, const E* __restrict__ Cm, const float* __restrict__ Dp,
    const float* __restrict__ hb, const E* __restrict__ gy, E* __restrict__ gx,
    float* __restrict__ gdt, float* __restrict__ pbc, float* __restrict__ pa,
    float* __restrict__ pd, float* __restrict__ lb, int M, int T, int D, int N,
    int group_start) {
  __shared__ float sx[2][CHUNK][BD], sdt[2][CHUNK][BD], sgy[2][CHUNK][BD];
  __shared__ float sbc[2][2][CHUNK][NMAX];  // B, C
  __shared__ float sred[CHUNK][NW][32];
  __shared__ float sgx[CHUNK][BD], sgdt[CHUNK][BD];
  const int ntiles = (D + BD - 1) / BD;
  const int m = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane % NG, cl = warp * CW + lane / NG;  // state group, channel in the block
  const int d = tile * BD + cl;
  const bool live = d < D;
  const int nchunks = (T + CHUNK - 1) / CHUNK;
  const size_t row0 = size_t(m) * T;
  const int n0 = PASS == ONLY ? 0 : group_start;  // the first state of this pass

  float a[NS], lam[NS], ga[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int n = n0 + grp * NS + k;
    a[k] = (live && n < N) ? A[size_t(d) * N + n] : 0.f;
    lam[k] = 0.f;
    ga[k] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;
  float a2[NS];  // A log2(e)
#pragma unroll
  for (int k = 0; k < NS; ++k) a2[k] = a[k] * 1.4426950408889634f;
  float gd = 0.f;

  // a chunk's inputs, loaded into registers a chunk ahead: PF of the
  // [CHUNK][BD] values of x, dt, gy and one of B or C a thread, and this
  // thread's NS values of the chunk's saved start state
  float px[PF], pdt[PF], pgy[PF], pbcv, ph[NS];
  auto fetch = [&](int c) {
    const int t0 = c * CHUNK, tc = min(CHUNK, T - t0);
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int e = tid + i * NT, t = e / BD, dc = tile * BD + e % BD;
      const bool ok = t < tc && dc < D;
      const size_t off = (row0 + t0 + t) * D + dc;
      px[i] = ok ? Elem<E>::load(x + off) : 0.f;
      pdt[i] = ok ? dt[off] : 0.f;
      pgy[i] = ok ? Elem<E>::load(gy + off) : 0.f;
    }
    const int w = tid / (CHUNK * NMAX), t = (tid / NMAX) % CHUNK, n = n0 + tid % NMAX;
    pbcv = t < tc && n < N ? Elem<E>::load((w ? Cm : Bm) + (row0 + t0 + t) * N + n) : 0.f;
    const float* src = hb + (size_t(c) * M + m) * N * D + d;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int n = n0 + grp * NS + k;
      ph[k] = (live && n < N) ? src[size_t(n) * D] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int e = tid + i * NT, t = e / BD, dl = e % BD;
      sx[buf][t][dl] = px[i];
      sdt[buf][t][dl] = pdt[i];
      sgy[buf][t][dl] = pgy[i];
    }
    sbc[buf][tid / (CHUNK * NMAX)][(tid / NMAX) % CHUNK][tid % NMAX] = pbcv;
  };

  fetch(nchunks - 1);
  stash(0);
  for (int c = nchunks - 1, buf = 0; c >= 0; --c, buf ^= 1) {
    const int t0 = c * CHUNK, tc = min(CHUNK, T - t0);
    float h[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) h[k] = ph[k];
    __syncthreads();  // this chunk's inputs are in; the last chunk's partials are written out
    if (c > 0) fetch(c - 1);

    // recompute the chunk's states (hs: before each frame)
    float hs[CHUNK][NS];
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      if (t >= tc) break;
      const float dtv = sdt[buf][t][cl], dbx = dtv * sx[buf][t][cl];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        hs[t][k] = h[k];
        h[k] = ex2(dtv * a2[k]) * h[k] + dbx * sbc[buf][0][t][grp * NS + k];
      }
    }

    // walk the chunk backwards; h holds the state after frame t
#pragma unroll
    for (int t = CHUNK - 1; t >= 0; --t) {
      if (t >= tc) continue;
      const float dtv = sdt[buf][t][cl], xv = sx[buf][t][cl], gyv = sgy[buf][t][cl];
      const float dbx = dtv * xv;
      float v[2 * NS];
      float lamB = 0.f, sA = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int n = grp * NS + k;
        lam[k] += gyv * sbc[buf][1][t][n];
        const float dA = ex2(dtv * a2[k]);
        const float g = lam[k] * hs[t][k] * dA;
        lamB += lam[k] * sbc[buf][0][t][n];
        sA += g * a[k];
        ga[k] += g * dtv;
        v[k] = lam[k] * dbx;
        v[NS + k] = gyv * h[k];
        lam[k] *= dA;
        h[k] = hs[t][k];
      }
      lamB = channel_sum(lamB);
      sA = channel_sum(sA);
      if (grp == 0) {
        if constexpr (PASS == ONLY) {
          sgdt[t][cl] = sA + lamB * xv;
          sgx[t][cl] = lamB * dtv + gyv * dd;
        } else {  // this group's parts; the last pass forms gdt and gx
          sgdt[t][cl] = sA;
          sgx[t][cl] = lamB;
        }
        if constexpr (PASS == ONLY || PASS == FIRST) gd += gyv * xv;
      }
      sred[t][warp][lane] = reduce_scatter(v, lane);
    }
    if (c > 0) stash(buf ^ 1);
    __syncthreads();

    // the chunk's gdt, gx and the block's gB, gC partials
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int e = tid + i * NT, t = e / BD, dl = e % BD, dc = tile * BD + dl;
      if (t < tc && dc < D) {
        const size_t off = (row0 + t0 + t) * D + dc;
        if constexpr (PASS == ONLY) {
          gdt[off] = sgdt[t][dl];
          Elem<E>::store(gx + off, sgx[t][dl]);
        } else if constexpr (PASS == FIRST) {
          gdt[off] = sgdt[t][dl];
          lb[off] = sgx[t][dl];
        } else if constexpr (PASS == MID) {
          gdt[off] += sgdt[t][dl];
          lb[off] += sgx[t][dl];
        } else {
          const float lamB = lb[off] + sgx[t][dl];
          gdt[off] = gdt[off] + sgdt[t][dl] + lamB * sx[buf][t][dl];
          Elem<E>::store(gx + off, lamB * sdt[buf][t][dl] + sgy[buf][t][dl] * Dp[dc]);
        }
      }
    }
    const int q2 = 2 * N;  // columns of pbc: gB's N, then gC's
    const int ng = min(NMAX, N - n0), qg = 2 * ng;  // this pass's states and columns
    for (int i = tid; i < tc * qg; i += NT) {
      const int t = i / qg, q = i % qg, n = q < ng ? q : q - ng;  // n: in this group
      const int l = ((q < ng ? 0 : NS) + n % NS) * NG + n / NS;  // the lane holding it
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sred[t][w][l];
      pbc[((size_t(tile) * M + m) * T + t0 + t) * q2 + (q < ng ? 0 : N) + n0 + n] = s;
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int n = n0 + grp * NS + k;
      if (n < N) pa[(size_t(m) * N + n) * D + d] = ga[k];
    }
    if constexpr (PASS == ONLY || PASS == FIRST)
      if (grp == 0) pd[size_t(m) * D + d] = gd;
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
  const long long lb = N > NMAX ? (long long)M * T * D : 0;  // lam . B across passes
  return ntiles * M * T * 2 * N + (long long)M * N * D + (long long)M * D + lb;
}

template <typename E, Pass PASS>
int launch_pass(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* Dp, const void* hb, const void* gy, void* gx, void* gdt,
                float* pbc, float* pa, float* pd, float* lb, int M, int T, int D, int N, int n0,
                cudaStream_t stream) {
  const int blocks = int((long long)M * ((D + BD - 1) / BD));
  selective_scan_bwd_kernel<E, PASS><<<blocks, NT, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const E*>(Bm), static_cast<const E*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(hb), static_cast<const E*>(gy), static_cast<E*>(gx),
      static_cast<float*>(gdt), pbc, pa, pd, lb, M, T, D, N, n0);
  return int(cudaGetLastError());
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
  float* lb = pd + (long long)M * D;
  if (N <= NMAX) {
    const int e = launch_pass<E, ONLY>(x, dt, A, Bm, Cm, Dp, hb, gy, gx, gdt, pbc, pa, pd,
                                       lb, M, T, D, N, 0, stream);
    if (e != 0) return e;
  } else {
    for (int n0 = 0; n0 < N; n0 += NMAX) {
      auto pass = n0 == 0 ? launch_pass<E, FIRST>
                  : n0 + NMAX < N ? launch_pass<E, MID> : launch_pass<E, LAST>;
      const int e = pass(x, dt, A, Bm, Cm, Dp, hb, gy, gx, gdt, pbc, pa, pd, lb, M, T, D, N,
                         n0, stream);
      if (e != 0) return e;
    }
  }
  cudaError_t err;
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
  if (M < 1 || T < 1 || D < 1 || N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, hb, gy, gx, gdt, gA, gB, gC,
                                         gD, ws, M, T, D, N, s)
                 : launch<float>(x, dt, A, Bm, Cm, Dp, hb, gy, gx, gdt, gA, gB, gC, gD, ws,
                                 M, T, D, N, s);
}
