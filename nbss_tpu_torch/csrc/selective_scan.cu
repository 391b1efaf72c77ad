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
// What bounds it on an H100: instruction throughput. At the serving shape (M =
// 2064, T = 251, D = 192, N = 16, bf16) one call reads x (199 MB), dt (398
// MB, the float32 softplus island) and B, C (33 MB), and writes y (199 MB):
// 0.25 ms at 3.35 TB/s. Every state update needs exp(dt A), M T D N = 1.59
// G of them; the special-function unit forms 16 an SM a clock, 0.38 ms on
// 132 SMs at 1.98 GHz. Each update also takes two multiplies and two
// multiply-adds, so the floor is the rate at which an SM dispatches those
// instructions, and the design keeps the walk to the state updates.
//
// Design. Four threads share a (sequence, channel), each holding four of its
// N <= 16 states in registers, so no [M, T, D, N] tensor ever exists and a
// block of 256 threads covers 64 channels of one sequence. exp(dt A) is
// ex2.approx(dt (A log2 e)), one special-function instruction, with A log2 e
// formed once a thread. The sum C . h over a channel's four threads is
// deferred over four frames and taken by a reduce-scatter (three shuffles for
// four frames), after which each thread holds one frame's sum. The inputs
// pass through shared memory 32 frames at a time, in their own types and
// double-buffered: the next span's x, dt, B and C are requested by 16-byte
// cp.async while the current span is walked, so no load waits on the walk
// (when D or N is not a multiple of 8, or a tensor does not start on 16
// bytes, rows are staged by plain loads). B and C are shared by every
// channel, so a block converts them to float32 once a span rather than
// every thread at every frame; the walk is branch-free (frames past T hold zeros, which leave the
// states unchanged) and reads shared memory at offsets fixed at compile
// time, so few instructions besides the updates remain. y leaves through
// shared memory as whole rows. N is padded to 16 with A = B = C = 0, so the
// padded states stay 0. Sums are taken in a fixed order (no atomics): two
// launches on the same inputs give the same bits.
//
// Any N. A state size above 16 runs in passes over groups of 16 states, one
// launch each (N = 17 pads its second group to 16): every state's recurrence
// is independent of the others', and they meet only in C . h. Each pass
// walks its group exactly as above and leaves its part of C . h, summed in
// float32, in a float32 buffer ypart [M, T, D]: the first pass writes it, the
// next ones add to it, and the last adds its own part, rounds the whole sum
// to x's type once and adds D x, the Pallas kernel's rounding point. The
// partial sums are added in the order of the groups, so relaunches stay
// bit-identical. Each extra pass costs the N = 16 walk again plus ypart's
// float32 read and write (0.8 GB at the serving shape); the exponentials,
// which bound the walk, grow with N whatever the design. The N <= 16 route
// is the single pass above, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int NMAX = 16;          // states of one pass
constexpr int CHUNK = 8;          // frames between saved states (ops/ssm.py CHUNK)
constexpr int NS = 4;             // states a thread
constexpr int NG = NMAX / NS;     // threads a channel
constexpr int BD = 64;            // channels a block
constexpr int NT = BD * NG;       // threads a block
constexpr int CW = 32 / NG;       // channels a warp
constexpr int TS = 32;            // frames a staged span
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TS % CHUNK == 0 && TS % NG == 0, "spans of whole chunks and frame groups");
static_assert(2 * TS * NMAX == 4 * NT, "B and C of a span: four values a thread");

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16(v); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
};

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, asynchronously; zeros when !ok
// (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v[u] is this thread's share of frame u's sum; the channel's NG threads
// (lanes NG c .. NG c + NG - 1) each get one frame's whole sum, thread s that
// of frame s. Each step hands half of the values still held to the partner.
__device__ __forceinline__ float reduce_scatter(float (&v)[NG], int grp) {
#pragma unroll
  for (int off = NG / 2, cnt = NG / 2; off >= 1; off >>= 1, cnt >>= 1) {
    const bool upper = grp & off;
#pragma unroll
    for (int i = 0; i < cnt; ++i) {
      const float send = upper ? v[i] : v[i + cnt];
      const float keep = upper ? v[i + cnt] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// A block's shared memory: two spans of inputs in their own types, this
// span's B and C in float32 (bf16 inputs only), y of one span.
template <typename E>
struct Stage {
  static constexpr bool CONVERT = sizeof(E) != sizeof(float);
  E x[2][TS][BD];
  float dt[2][TS][BD];
  E bc[2][2][TS][NMAX];  // B, C
  float bcf[2][TS][CONVERT ? NMAX : 1];
  E y[TS][BD];
};

// How a launch finishes C . h: ONLY for N <= 16 (round, add D x, write y);
// for a pass over states n0 .. n0 + 15 of a larger N, FIRST writes its
// float32 part to ypart, MID adds it there, LAST adds it to ypart's sum, rounds
// and writes y.
enum Pass { ONLY, FIRST, MID, LAST };

// One block per (sequence m, tile of 64 channels); thread (channel c, group
// s) holds states n0 + 4s .. n0 + 4s + 3 of channel c. ALIGNED: D and N
// multiples of 8 and x, dt, B, C, y starting on 16 bytes, so that every
// staged row does.
template <typename E, bool ALIGNED, Pass PASS>
__global__ void __launch_bounds__(NT, 4) selective_scan_kernel(
    const E* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const E* __restrict__ Bm, const E* __restrict__ Cm, const float* __restrict__ Dp,
    E* __restrict__ y, float* __restrict__ hb, float* __restrict__ ypart, int M, int T, int D,
    int N, int group_start) {
  extern __shared__ uint4 smem_raw[];
  Stage<E>& sm = *reinterpret_cast<Stage<E>*>(smem_raw);
  constexpr int EV = 16 / sizeof(E);  // values of E in 16 bytes
  const int ntiles = (D + BD - 1) / BD;
  const int m = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane % NG, cl = warp * CW + lane / NG;  // state group, channel in the block
  const int d0 = tile * BD, d = d0 + cl;
  const bool live = d < D;
  const size_t row0 = size_t(m) * T;
  const int n0 = PASS == ONLY ? 0 : group_start;  // the first state of this pass

  float a2[NS], h[NS];  // A log2(e), the states
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int n = n0 + grp * NS + k;
    a2[k] = (live && n < N) ? A[size_t(d) * N + n] * LOG2E : 0.f;
    h[k] = 0.f;
  }
  const float dd = live ? Dp[d] : 0.f;

  // span sp's inputs into buffer buf: zeros past T, D and N
  auto fetch = [&](int sp, int buf) {
    const int t0 = sp * TS, tc = min(TS, T - t0);
    if constexpr (ALIGNED) {
      constexpr int XC = BD / EV, DC = BD / 4, NC = NMAX / EV;  // 16-byte chunks a row
#pragma unroll
      for (int i = 0; i < (TS * XC + NT - 1) / NT; ++i) {
        const int c = tid + i * NT, t = c / XC, dc = d0 + (c % XC) * EV;
        const bool ok = t < tc && dc < D;
        if (c < TS * XC)
          cp_async16(&sm.x[buf][t][(c % XC) * EV], ok ? x + (row0 + t0 + t) * D + dc : x, ok);
      }
#pragma unroll
      for (int i = 0; i < TS * DC / NT; ++i) {
        const int c = tid + i * NT, t = c / DC, dc = d0 + (c % DC) * 4;
        const bool ok = t < tc && dc < D;
        cp_async16(&sm.dt[buf][t][(c % DC) * 4], ok ? dt + (row0 + t0 + t) * D + dc : dt, ok);
      }
#pragma unroll
      for (int i = 0; i < (2 * TS * NC + NT - 1) / NT; ++i) {
        const int c = tid + i * NT, w = c / (TS * NC), t = (c / NC) % TS, n = (c % NC) * EV;
        const bool ok = t < tc && n0 + n < N;
        const E* src = w ? Cm : Bm;
        if (c < 2 * TS * NC)
          cp_async16(&sm.bc[buf][w][t][n], ok ? src + (row0 + t0 + t) * N + n0 + n : src, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int e = tid; e < TS * BD; e += NT) {
        const int t = e / BD, dl = e % BD, dc = d0 + dl;
        const bool ok = t < tc && dc < D;
        const size_t off = (row0 + t0 + t) * D + dc;
        sm.x[buf][t][dl] = ok ? x[off] : Elem<E>::from(0.f);
        sm.dt[buf][t][dl] = ok ? dt[off] : 0.f;
      }
      for (int e = tid; e < 2 * TS * NMAX; e += NT) {
        const int w = e / (TS * NMAX), t = (e / NMAX) % TS, n = e % NMAX;
        sm.bc[buf][w][t][n] = t < tc && n0 + n < N ? (w ? Cm : Bm)[(row0 + t0 + t) * N + n0 + n]
                                                    : Elem<E>::from(0.f);
      }
    }
  };
  // y of span sp from shared memory
  auto write_y = [&](int sp) {
    const int t0 = sp * TS, tc = min(TS, T - t0);
    if constexpr (ALIGNED) {
      constexpr int YC = BD / EV;
#pragma unroll
      for (int i = 0; i < (TS * YC + NT - 1) / NT; ++i) {
        const int c = tid + i * NT, t = c / YC, dc = d0 + (c % YC) * EV;
        if (c < TS * YC && t < tc && dc < D)
          *reinterpret_cast<uint4*>(y + (row0 + t0 + t) * D + dc) =
              *reinterpret_cast<const uint4*>(&sm.y[t][(c % YC) * EV]);
      }
    } else {
      for (int e = tid; e < TS * BD; e += NT) {
        const int t = e / BD, dl = e % BD;
        if (t < tc && d0 + dl < D) y[(row0 + t0 + t) * D + d0 + dl] = sm.y[t][dl];
      }
    }
  };

  const int nspans = (T + TS - 1) / TS;
  const size_t hb_chunk = size_t(M) * N * D;  // hb's stride from one chunk to the next
  fetch(0, 0);
  for (int sp = 0, buf = 0; sp < nspans; ++sp, buf ^= 1) {
    const int t0 = sp * TS, tc = min(TS, T - t0);
    if constexpr (ALIGNED) cp_async_wait_all();
    __syncthreads();  // span sp's inputs are in; y of span sp - 1 is complete
    if constexpr (PASS == ONLY || PASS == LAST)
      if (sp > 0) write_y(sp - 1);
    if constexpr (Stage<E>::CONVERT) {  // B and C of span sp to float32, four a thread
      const int e = 4 * tid;
      const E* src = &sm.bc[buf][0][0][0] + e;
      float4 v;
      v.x = Elem<E>::load(src), v.y = Elem<E>::load(src + 1);
      v.z = Elem<E>::load(src + 2), v.w = Elem<E>::load(src + 3);
      *reinterpret_cast<float4*>(&sm.bcf[0][0][0] + e) = v;
    }
    if (sp + 1 < nspans) fetch(sp + 1, buf ^ 1);
    __syncthreads();  // B and C in float32; y of span sp - 1 is read out

    const float* pdt = &sm.dt[buf][0][cl];
    const E* px = &sm.x[buf][0][cl];
    const float* pb = Stage<E>::CONVERT ? &sm.bcf[0][0][0]
                                        : reinterpret_cast<const float*>(&sm.bc[buf][0][0][0]);
    pb += grp * NS;
    const float* pc = pb + TS * NMAX;
    float* hbp = hb != nullptr && live
                     ? hb + (size_t(t0 / CHUNK) * M + m) * N * D + size_t(n0 + grp * NS) * D + d
                     : nullptr;
    // the earlier passes' part of C . h at this thread's frames q + grp
    float part[TS / NG];
    if constexpr (PASS == MID || PASS == LAST) {
#pragma unroll
      for (int i = 0; i < TS / NG; ++i) {
        const int t = i * NG + grp;
        part[i] = live && t < tc ? ypart[(row0 + t0 + t) * D + d] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < TS; q += NG) {
      float p[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int t = q + u;
        if (t % CHUNK == 0 && hbp != nullptr && t < tc) {
          float* dst = hbp + (t / CHUNK) * hb_chunk;
#pragma unroll
          for (int k = 0; k < NS; ++k)
            if (n0 + grp * NS + k < N) dst[size_t(k) * D] = h[k];
        }
        // frames past T hold zeros (dt = x = B = 0): the states pass unchanged
        const float dtv = pdt[t * BD];
        const float dbx = dtv * Elem<E>::load(px + t * BD);
        const float4 bv = *reinterpret_cast<const float4*>(pb + t * NMAX);
        const float4 cv = *reinterpret_cast<const float4*>(pc + t * NMAX);
        const float bk[NS] = {bv.x, bv.y, bv.z, bv.w}, ck[NS] = {cv.x, cv.y, cv.z, cv.w};
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          h[k] = fmaf(ex2(dtv * a2[k]), h[k], dbx * bk[k]);
          acc = fmaf(h[k], ck[k], acc);
        }
        p[u] = acc;
      }
      const float sum = reduce_scatter(p, grp);  // C . h at frame q + grp
      if constexpr (PASS == ONLY) {
        const float xv = Elem<E>::load(px + (q + grp) * BD);
        sm.y[q + grp][cl] = Elem<E>::from(Elem<E>::round(sum) + xv * dd);
      } else if constexpr (PASS == LAST) {
        const float xv = Elem<E>::load(px + (q + grp) * BD);
        sm.y[q + grp][cl] = Elem<E>::from(Elem<E>::round(part[q / NG] + sum) + xv * dd);
      } else if (live && q + grp < tc) {
        ypart[(row0 + t0 + q + grp) * D + d] = PASS == FIRST ? sum : part[q / NG] + sum;
      }
    }
  }
  if constexpr (PASS == ONLY || PASS == LAST) {
    __syncthreads();
    write_y(nspans - 1);
  }
}

template <typename E, Pass PASS>
int launch_pass(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                const void* Dp, void* y, void* hb, void* ypart, int M, int T, int D, int N,
                int n0, bool aligned, cudaStream_t stream) {
  auto kernel = aligned ? selective_scan_kernel<E, true, PASS>
                        : selective_scan_kernel<E, false, PASS>;
  constexpr int smem = sizeof(Stage<E>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<int((long long)M * ((D + BD - 1) / BD)), NT, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const E*>(Bm), static_cast<const E*>(Cm), static_cast<const float*>(Dp),
      static_cast<E*>(y), static_cast<float*>(hb), static_cast<float*>(ypart), M, T, D, N, n0);
  return int(cudaGetLastError());
}

template <typename E>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* Dp, void* y, void* hb, void* ypart, int M, int T, int D, int N,
           cudaStream_t stream) {
  const long long blocks = (long long)M * ((D + BD - 1) / BD);
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  auto on16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = D % 8 == 0 && N % 8 == 0 && on16(x) && on16(dt) && on16(Bm) &&
                       on16(Cm) && on16(y);
  if (N <= NMAX)
    return launch_pass<E, ONLY>(x, dt, A, Bm, Cm, Dp, y, hb, ypart, M, T, D, N, 0, aligned,
                                stream);
  if (ypart == nullptr) return int(cudaErrorInvalidValue);
  for (int n0 = 0; n0 < N; n0 += NMAX) {
    auto pass = n0 == 0 ? launch_pass<E, FIRST>
                : n0 + NMAX < N ? launch_pass<E, MID> : launch_pass<E, LAST>;
    const int err = pass(x, dt, A, Bm, Cm, Dp, y, hb, ypart, M, T, D, N, n0, aligned, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// y = scan(x, dt, A, B, C) + D x on `stream`; hb (may be null) receives the
// chunk-start states. x, B, C, y are bfloat16 when is_bf16, else float32.
// ypart: float32 scratch [M, T, D] for N > 16 (one pass a group of 16 states),
// unused (may be null) otherwise. Returns the first CUDA launch error (0 on
// success).
extern "C" int nbss_selective_scan_fwd(const void* x, const void* dt, const void* A,
                                       const void* Bm, const void* Cm, const void* Dp,
                                       void* y, void* hb, void* ypart, int M, int T, int D,
                                       int N, int is_bf16, void* stream) {
  if (M < 1 || T < 1 || D < 1 || N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, y, hb, ypart, M, T, D, N, s)
                 : launch<float>(x, dt, A, Bm, Cm, Dp, y, hb, ypart, M, T, D, N, s);
}

extern "C" int nbss_selective_scan_chunk() { return CHUNK; }

// States one pass of either scan kernel holds (ops/ssm.py STATE_GROUP).
extern "C" int nbss_selective_scan_state_group() { return NMAX; }
