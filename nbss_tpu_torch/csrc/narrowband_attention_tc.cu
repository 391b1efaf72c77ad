// Narrow-band multi-head attention, forward, on Hopper's bf16 tensor cores
// (sm_90a, mma.sync). The bf16 counterpart of narrowband_attention.cu, which
// keeps the float32 inputs.
//
// For each of M sequences of T frames and each head h:
//
//     s = q_h k_h^T / sqrt(dh) + mask_h,   m = rowmax(s),   e = exp(s - m)
//     o_h = round(round(e) v_h * (1 / sum(e)))
//
// with the Pallas kernel's rounding points: the float32 product, then the
// scale, then the mask; the row max exact over all T keys before any e is
// formed; e rounded to bf16 where it meets v, the product summed in float32,
// scaled by the reciprocal of the float32 sum of the unrounded e, and rounded
// once. q, k, v, o are bf16; the mask (none, [T, T] or [nh, T, T]) float32.
// When `stats` is given, m and 1 / sum(e) are written there as float32
// [2, M, nh, T] for narrowband_attention_bwd.cu.
//
// Replaces the Pallas TPU kernel narrowband_attention / _fused_forward
// (_kernel, _kernel_nomask) in nbss_tpu/ops/attention.py, for bf16 inputs.
//
// What bounds it on an H100: memory. At the mhsa(251) serving shape (M =
// 2064, T = 251, nh = 4, dh = dv = 24, causal [T, T] mask) the function moves
// 398 MB (q, k, v, o and the mask: 119 us at 3.35 TB/s) and does 50 GFLOP of
// products (51 us at 989 TFLOP/s); at NBC's post-LN shape (M = 4112, T =
// 248, nh = 8, dh = 216, dv = 24) 7.8 GB (2.34 ms) against 0.97 TFLOP (0.98
// ms). The design:
//
// - One block per (sequence, head) stages that head's K and V once, as bf16
//   in shared memory (cp.async), with rows padded so that ldmatrix reads
//   are free of bank conflicts; q, k and v leave device memory once.
// - Every product is mma.sync m16n8k16, bf16 operands, float32 accumulator.
//   The head widths are padded with zeros: dh to a multiple of 16 (24 ->
//   32, 216 -> 224), dv to 24 or 64.
// - Up to 256 keys (T = 251 and 248 on the main paths), eight warps walk
//   the query tiles of 16 rows in pairs: each warp of a pair holds the
//   scores of the tile's rows against one half of the keys in registers (64
//   a thread), the pair exchanges the row max through shared memory, so it
//   is exact over all T keys before any e is formed, then each warp forms e
//   in float32, adds its sum, and feeds round(e) straight into the e v
//   product as A fragments (the accumulator layout of m16n8k16 is the A
//   layout of the next product); the second warp hands its sums and its
//   partial product to the first, which writes the tile. Holding half the
//   scores halves the registers (128 instead of 255 with spills), which
//   doubles the warps an SM keeps. A pair stages its next tile's q rows
//   while it finishes the current one.
// - A one-pass online softmax would rescale weights that are already
//   rounded, so longer T takes one warp a tile and two passes over chunks of
//   256 keys: the row max first, then e.
// - Keys >= T are masked by index; padded rows and columns are zero. A mask
//   is the largest per-tile input at dh 24 (16 KB of float32 rows against
//   1.5 KB of q): the 16 rows of a tile are one contiguous run of the [T, T]
//   mask, staged by the pair with 16-byte cp.async where it fits in shared
//   memory, else read from global memory at each score's position. Whether
//   and how a kernel reads the mask is a template parameter, so the
//   unmasked kernel carries no mask code (NBC's wide heads: 128 registers).
//
// What holds it back at the wide shape: K of one head (248 x 224 bf16,
// 119 KB) fills half of an SM's shared memory, so an SM runs one block and
// the K/V load of each (sequence, head) is not overlapped with compute.

#include <climits>

#include "narrowband_attention_tc.cuh"

namespace {

using namespace nbss_attn_tc;

constexpr int KPAIRS = KC / 16;     // 16-key blocks of a chunk

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;  // null, or [mask_heads, T, T]
  bf16* o;            // [M, T, nh * dv], contiguous
  float* stats;       // null, or [2, M, nh, T]
  long long ldq, ldk, ldv;
  int M, T, nh, dh, dv, mask_heads;
  int dp;             // dh padded to a multiple of 16
  int vq, vk, vv;     // rows of q, k, v may be copied 16 bytes at a time
  float scale;
};

// The row max of S for rows g (mx[0]) and g + 8 (mx[1]) over the quad.
template <int NP>
__device__ __forceinline__ void row_max(const float (&S)[2 * NP][4], float (&mx)[2]) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) {
    m0 = fmaxf(m0, fmaxf(S[n][0], S[n][1]));
    m1 = fmaxf(m1, fmaxf(S[n][2], S[n][3]));
  }
  mx[0] = fmaxf(mx[0], quad_max(m0));
  mx[1] = fmaxf(mx[1], quad_max(m1));
}

// e = exp(s - m) in float32, its sum into l (this thread's keys), and
// round(e) v into O, over the first np of the NP key blocks of Vs.
template <int NP, bool FULL, int DVP>
__device__ __forceinline__ void weights_times_v(float (&S)[2 * NP][4], const float (&mx)[2],
                                                float (&l)[2], float (&O)[DVP / 8][4],
                                                const bf16* Vs, int VS, int np, int lane) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (FULL || p < np) {
#pragma unroll
      for (int n = 2 * p; n < 2 * p + 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = exp_shifted(S[n][e], mx[e >> 1]);
          S[n][e] = x;
          l[e >> 1] += x;
        }
      }
      uint32_t A[4];
      pack_a(A, S[2 * p], S[2 * p + 1]);
#pragma unroll
      for (int nv = 0; nv < DVP / 8; ++nv) {
        uint32_t B[2];
        ldsm_x2_t(B, Vs + (p * 16 + (lane & 15)) * VS + nv * 8);
        mma(O[nv], A, B[0], B[1]);
      }
    }
  }
}

// o = O / lsum rounded once, and the row statistics; lsum is the whole row's
// sum of e.
template <int DVP>
__device__ __forceinline__ void finish(const Args& a, float (&O)[DVP / 8][4], const float (&mx)[2],
                                       const float (&lsum)[2], size_t row0, int m, int h, int i0,
                                       int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const float rinv[2] = {1.f / lsum[0], 1.f / lsum[1]};
#pragma unroll
  for (int nv = 0; nv < DVP / 8; ++nv) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8, col = nv * 8 + 2 * t4 + (e & 1);
      if (i < a.T && col < a.dv)
        a.o[(row0 + i) * size_t(a.nh) * a.dv + size_t(h) * a.dv + col] =
            __float2bfloat16(O[nv][e] * rinv[e >> 1]);
    }
  }
  if (a.stats != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i < a.T) {
        const size_t s = (size_t(m) * a.nh + h) * a.T + i;
        a.stats[s] = mx[r];
        a.stats[size_t(a.M) * a.nh * a.T + s] = rinv[r];
      }
    }
  }
}


// Named barrier of the KSPLIT warps that share a query tile.
template <int KSPLIT>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (KSPLIT == 1)
    __syncwarp();
  else
    named_barrier(1 + grp, 32 * KSPLIT);
}

// Shared memory of a launch: K and V of a chunk, one q tile per group of
// KSPLIT warps, with stage_mask the mask rows of each group's tile, and with
// KSPLIT = 2 the exchange of row max, row sum and partial output.
template <int DVP, int NW, int KSPLIT>
struct Smem {
  static constexpr int NG = NW / KSPLIT;
  static constexpr int XCH = 3 * 16 + (DVP / 8) * 4 * 32;  // floats a group exchanges
  size_t k, v, q, m, x, total;
  __host__ __device__ Smem(const Args& a, bool stage_mask) {
    const size_t Tk16 = (min(a.T, KC) + 15) & ~15;
    k = 0;
    v = k + Tk16 * row_stride(a.dp) * 2;
    q = v + Tk16 * row_stride(DVP) * 2;
    m = q + size_t(NG) * 16 * row_stride(a.dp) * 2;  // every part starts 16-byte aligned
    x = m + (stage_mask ? size_t(NG) * 16 * Tk16 * 4 : 0);
    total = x + (KSPLIT > 1 ? size_t(NG) * XCH * 4 : 0);
  }
};

// One block per (sequence, head). Groups of KSPLIT warps walk the query
// tiles of 16 rows; with KSPLIT = 2 the two warps of a group take one half of
// the keys each (64 score registers instead of 128), and exchange the row max
// before e and the row sums and partial products after.
template <int DVP, int NW, int KSPLIT, bool ONE_CHUNK, int MM>
__global__ void __launch_bounds__(NW * 32) narrowband_attention_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = NW * 32;
  constexpr int VS = row_stride(DVP);
  constexpr int NG = NW / KSPLIT;        // query tiles in flight
  constexpr int NP = KPAIRS / KSPLIT;    // 16-key blocks of scores a warp holds
  const Smem<DVP, NW, KSPLIT> L(a, MM == MASK_STAGED);
  const int KS = row_stride(a.dp);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L.k);  // [Tk16][KS]
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.v);  // [Tk16][VS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % a.nh, m = blockIdx.x / a.nh;
  const size_t row0 = size_t(m) * a.T;
  const float* mask =
      a.mask == nullptr ? nullptr : a.mask + size_t(a.mask_heads > 1 ? h : 0) * a.T * a.T;
  const int grp = warp / KSPLIT, hf = warp % KSPLIT;
  bf16* Qg = reinterpret_cast<bf16*>(smem_raw + L.q) + grp * 16 * KS;
  const int Tk16 = (min(a.T, KC) + 15) & ~15;
  float* Mg = MM == MASK_STAGED ? reinterpret_cast<float*>(smem_raw + L.m) + grp * 16 * Tk16
                                : nullptr;
  const int ntiles = (a.T + 15) / 16;

  auto stage_chunk = [&](int c, bool with_v) {
    const int j0 = c * KC, n16 = (min(KC, a.T - j0) + 15) & ~15;
    stage(Ks, KS, a.dp, a.k, a.ldk, row0, j0, n16, a.T, h * a.dh, a.dh, a.vk, tid, NT);
    if (with_v) stage(Vs, VS, DVP, a.v, a.ldv, row0, j0, n16, a.T, h * a.dv, a.dv, a.vv, tid, NT);
  };

  float S[2 * NP][4];
  if constexpr (ONE_CHUNK) {
    // one chunk: K and V once; each group's warps own keys [j0, j0 + 16 NP)
    const int j0 = hf * NP * 16;
    const int np = max(0, min(NP, (a.T - j0 + 15) / 16));
    const bool full = np == NP && a.T - j0 > NP * 16 - 16;
    float* X = KSPLIT > 1 ? reinterpret_cast<float*>(smem_raw + L.x) + grp * Smem<DVP, NW, KSPLIT>::XCH
                          : nullptr;
    // this warp's share of the q rows (and mask rows) of the tile at i0, asynchronously
    auto issue = [&](int i0) {
      constexpr int QR = 16 / KSPLIT;
      stage(Qg + hf * QR * KS, KS, a.dp, a.q, a.ldq, row0, i0 + hf * QR, QR, a.T, h * a.dh, a.dh,
            a.vq, lane, 32);
      if constexpr (MM == MASK_STAGED) stage_mask_rows(Mg, mask, a.T, i0, hf, KSPLIT, lane);
    };
    stage_chunk(0, true);
    if (grp < ntiles) issue(grp * 16);
    cp_async_wait_all();
    __syncthreads();
    for (int rt = grp; rt < ntiles; rt += NG) {
      const int i0 = rt * 16;
      if (rt != grp) {
        cp_async_wait_all();
        group_sync<KSPLIT>(grp);
      }
      if (full)
        scores<NP, true, MM>(S, Qg, Ks + j0 * KS, KS, np, a.dp, a.T, a.scale, mask, Mg, a.T, 0, i0,
                             j0, lane);
      else
        scores<NP, false, MM>(S, Qg, Ks + j0 * KS, KS, np, a.dp, a.T, a.scale, mask, Mg, a.T, 0, i0,
                              j0, lane);
      float mx[2] = {-INFINITY, -INFINITY};
      row_max<NP>(S, mx);
      if constexpr (KSPLIT > 1) {
        if ((lane & 3) == 0) {
          X[hf * 16 + (lane >> 2)] = mx[0];
          X[hf * 16 + (lane >> 2) + 8] = mx[1];
        }
      }
      group_sync<KSPLIT>(grp);  // both halves' max is out; Qg and Mg are free
      if constexpr (KSPLIT > 1) {
        mx[0] = fmaxf(mx[0], X[(1 - hf) * 16 + (lane >> 2)]);
        mx[1] = fmaxf(mx[1], X[(1 - hf) * 16 + (lane >> 2) + 8]);
      }
      if (rt + NG < ntiles) issue(i0 + NG * 16);
      float l[2] = {0.f, 0.f}, O[DVP / 8][4] = {};
      if (full)
        weights_times_v<NP, true, DVP>(S, mx, l, O, Vs + j0 * VS, VS, np, lane);
      else
        weights_times_v<NP, false, DVP>(S, mx, l, O, Vs + j0 * VS, VS, np, lane);
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
      if constexpr (KSPLIT > 1) {
        // the second half's sums and products to the first, which writes the tile
        float* xl = X + 32;
        float* xo = X + 48;
        if (hf == 1) {
          if ((lane & 3) == 0) {
            xl[lane >> 2] = l[0];
            xl[(lane >> 2) + 8] = l[1];
          }
#pragma unroll
          for (int nv = 0; nv < DVP / 8; ++nv)
#pragma unroll
            for (int e = 0; e < 4; ++e) xo[(nv * 4 + e) * 32 + lane] = O[nv][e];
        }
        group_sync<KSPLIT>(grp);
        if (hf == 0) {
          l[0] += xl[lane >> 2];
          l[1] += xl[(lane >> 2) + 8];
#pragma unroll
          for (int nv = 0; nv < DVP / 8; ++nv)
#pragma unroll
            for (int e = 0; e < 4; ++e) O[nv][e] += xo[(nv * 4 + e) * 32 + lane];
          finish<DVP>(a, O, mx, l, row0, m, h, i0, lane);
        }
      } else {
        finish<DVP>(a, O, mx, l, row0, m, h, i0, lane);
      }
    }
  } else if constexpr (KSPLIT == 1) {
    // T > KC: two passes over the key chunks, every warp through every barrier
    auto stage_q = [&](int i0) {
      __syncwarp();  // the warp is done with its previous tile
      stage(Qg, KS, a.dp, a.q, a.ldq, row0, i0, 16, a.T, h * a.dh, a.dh, a.vq, lane, 32);
      cp_async_wait_all();
      __syncwarp();
    };
    const int nchunks = (a.T + KC - 1) / KC;
    const int iters = (ntiles + NW - 1) / NW;
    for (int it = 0; it < iters; ++it) {
      const int rt = it * NW + warp, i0 = rt * 16;
      const bool active = rt < ntiles;
      if (active) stage_q(i0);
      float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, O[DVP / 8][4] = {};
      for (int c = 0; c < nchunks; ++c) {
        const int np = (min(KC, a.T - c * KC) + 15) / 16;
        __syncthreads();
        stage_chunk(c, false);
        cp_async_wait_all();
        __syncthreads();
        if (active) {
          scores<NP, false, MM>(S, Qg, Ks, KS, np, a.dp, a.T, a.scale, mask, nullptr, a.T, 0, i0,
                                c * KC, lane);
          row_max<NP>(S, mx);
        }
      }
      for (int c = 0; c < nchunks; ++c) {
        const int np = (min(KC, a.T - c * KC) + 15) / 16;
        __syncthreads();
        stage_chunk(c, true);
        cp_async_wait_all();
        __syncthreads();
        if (active) {
          scores<NP, false, MM>(S, Qg, Ks, KS, np, a.dp, a.T, a.scale, mask, nullptr, a.T, 0, i0,
                                c * KC, lane);
          weights_times_v<NP, false, DVP>(S, mx, l, O, Vs, VS, np, lane);
        }
      }
      if (active) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
        finish<DVP>(a, O, mx, l, row0, m, h, i0, lane);
      }
    }
  }
}

template <int DVP, int NW, int KSPLIT>
bool fits(const Args& a, bool stage_mask) {
  return Smem<DVP, NW, KSPLIT>(a, stage_mask).total <= size_t(SMEM_MAX);
}

template <int DVP, int NW, int KSPLIT, bool ONE_CHUNK, int MM>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Smem<DVP, NW, KSPLIT>(a, MM == MASK_STAGED).total;
  if (smem > size_t(SMEM_MAX)) return int(cudaErrorInvalidValue);
  auto kernel = narrowband_attention_tc_kernel<DVP, NW, KSPLIT, ONE_CHUNK, MM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<a.M * a.nh, NW * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// Up to KC keys: eight warps, each query tile's keys split over two of
// them, the tile's mask rows staged where they fit, else read from global
// memory. Longer sequences: four warps, one a tile, two passes over the key
// chunks.
template <int DVP>
int launch_dv(const Args& a, cudaStream_t stream) {
  if (a.T > KC)
    return a.mask == nullptr ? launch<DVP, 4, 1, false, MASK_NONE>(a, stream)
                             : launch<DVP, 4, 1, false, MASK_GLOBAL>(a, stream);
  if (a.mask == nullptr) return launch<DVP, 8, 2, true, MASK_NONE>(a, stream);
  if (fits<DVP, 8, 2>(a, true)) return launch<DVP, 8, 2, true, MASK_STAGED>(a, stream);
  return launch<DVP, 8, 2, true, MASK_GLOBAL>(a, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// o = attention(q, k, v, mask) in bf16 on `stream`; stats (may be null)
// receives the row max and 1 / row sum for the backward. ldq, ldk, ldv are
// the row strides of q, k, v in elements; mask is null or float32
// [mask_heads, T, T] with mask_heads 1 or nh. Returns the CUDA error of the
// launch (0 on success); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int nbss_narrowband_attention_tc_fwd(const void* q, const void* k, const void* v,
                                                const void* mask, void* o, void* stats,
                                                long long ldq, long long ldk, long long ldv,
                                                int M, int T, int nh, int dh, int dv,
                                                int mask_heads, float scale, void* stream) {
  if (M < 1 || T < 1 || nh < 1 || dh < 1 || dv < 1 || dh > DKMAX || dv > DVMAX ||
      (long long)M * nh > INT_MAX || (mask != nullptr && mask_heads != 1 && mask_heads != nh))
    return int(cudaErrorInvalidValue);
  auto vec = [](const void* p, long long ld, int d) {
    return int(aligned16(p) && ld % 8 == 0 && d % 8 == 0);
  };
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask),
               static_cast<bf16*>(o), static_cast<float*>(stats), ldq, ldk, ldv, M, T, nh, dh,
               dv, mask_heads, (dh + 15) & ~15, vec(q, ldq, dh), vec(k, ldk, dh),
               vec(v, ldv, dv), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dv <= 24 ? launch_dv<24>(a, s) : launch_dv<64>(a, s);
}
