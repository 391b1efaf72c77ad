// Narrow-band multi-head attention, forward, for Hopper (sm_90a), float32
// inputs on the CUDA cores; bf16 inputs take narrowband_attention_tc.cu.
//
// For each of M sequences of T frames and each head h:
//
//     s = q_h k_h^T / sqrt(dh) + mask_h,   m = rowmax(s),   e = exp(s - m)
//     o_h = round(round(e) v_h * (1 / sum(e)))
//
// with float32 scores, sums and products; round(e) is e in v's type (the
// unnormalized weights are rounded, the product with v summed in float32,
// then scaled by the reciprocal of the float32 row sum and rounded once).
// These are the Pallas kernel's rounding points. q, k, v and o are float32
// here; the mask (none, [T, T] or [nh, T, T]) float32. When `stats`
// is given, the row max m and 1 / sum(e) are written there as float32
// [2, M, nh, T] for narrowband_attention_bwd.cu.
//
// Replaces the Pallas TPU kernel narrowband_attention / _fused_forward
// (_kernel, _kernel_nomask) in nbss_tpu/ops/attention.py.
//
// What bounds it on an H100: at the serving shape (M = 2064, T = 251,
// nh = 4, dh = dv = 24, bf16) the function moves 199 MB (59 us at 3.35
// TB/s) and does 50 GFLOP of products (50 us at 989 TFLOP/s, the
// tensor-core rate) and 520 M exps. This kernel runs on the CUDA cores in
// float32 and, being simple, in two passes over the keys: the first finds
// each row's max, the second forms e with the final max, so round(e) is the
// Pallas kernel's for any T (a one-pass online softmax would rescale the
// already-rounded weights). That is about 75 GFLOP of float32 FMA, a 1.1 ms
// floor at 67 TFLOP/s. One block takes one (sequence, head) and 64 query
// rows, a thread one query row: q_i and the output accumulator stay in
// registers, and K, V and the mask pass through shared memory 32 keys at a
// time, so no [T, T] score matrix exists. Head widths are padded with zeros
// to 16, 24, 32 or 64 (compiled variants); any M, T >= 1 is taken.
//
// Wider q/k heads, 64 < dh <= 256 (NBC's augmented heads, dh + d_model =
// 216, with dv = 24), take a second kernel: four threads share a query row,
// each with a 64-wide chunk of q_i in registers and a quarter of the output
// row, and a score is the sum of the four chunk dots, added in one fixed
// order in every kernel (group_sum), so the backward's e and dS still agree
// with the forward's bit for bit. v heads stay <= 64 wide.

#include <climits>
#include <cmath>

#include "narrowband_attention.cuh"

namespace {

using namespace nbss_attn;

constexpr int QT = 64;  // query rows (threads) per block
constexpr int KT = 32;  // keys staged in shared memory at a time

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // null, or [mask_heads, T, T]
  void* o;            // [M, T, nh * dv], contiguous
  float* stats;       // null, or [2, M, nh, T]
  long long ldq, ldk, ldv;
  int M, T, nh, dh, dv, mask_heads;
  float scale;
};

template <typename E, int D>
__global__ void __launch_bounds__(QT) narrowband_attention_kernel(const FwdArgs a) {
  __shared__ __align__(16) float sk[KT][D];
  __shared__ __align__(16) float sv[KT][D];
  __shared__ float sm[QT][KT + 1];  // mask tile; the odd stride spreads a column over the banks
  const int ntiles = (a.T + QT - 1) / QT;
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % a.nh;
  const int m = blockIdx.x / ntiles / a.nh;
  const int tid = threadIdx.x;
  const int i = tile * QT + tid;
  const bool live = i < a.T;
  const size_t row0 = size_t(m) * a.T;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const float* mask = head_mask(a.mask, a.mask_heads, h, a.T);

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = (live && d < a.dh) ? Elem<E>::load(q + (row0 + i) * a.ldq + h * a.dh + d) : 0.f;
    acc[d] = 0.f;
  }

  // pass 1: the row max
  float mx = -INFINITY;
  for (int j0 = 0; j0 < a.T; j0 += KT) {
    const int kc = min(KT, a.T - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<E, D, KT, QT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    if (mask != nullptr) stage_mask<QT, KT, KT + 1, QT>(&sm[0][0], mask, a.T, tile * QT, j0, tid);
    __syncthreads();
    if (live)
      for (int j = 0; j < kc; ++j)
        mx = fmaxf(mx, score<D>(qr, sk[j], a.scale, mask != nullptr ? &sm[tid][j] : nullptr));
  }

  // pass 2: e with the final max, its float32 sum and round(e) v
  float l = 0.f;
  for (int j0 = 0; j0 < a.T; j0 += KT) {
    const int kc = min(KT, a.T - j0);
    __syncthreads();
    stage_rows<E, D, KT, QT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    stage_rows<E, D, KT, QT>(sv, v, a.ldv, row0 + j0, h * a.dv, a.dv, kc, tid);
    if (mask != nullptr) stage_mask<QT, KT, KT + 1, QT>(&sm[0][0], mask, a.T, tile * QT, j0, tid);
    __syncthreads();
    if (live)
      for (int j = 0; j < kc; ++j) {
        const float e = expf(
            score<D>(qr, sk[j], a.scale, mask != nullptr ? &sm[tid][j] : nullptr) - mx);
        l += e;
        const float eb = Elem<E>::round(e);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(eb, sv[j][d], acc[d]);
      }
  }
  if (!live) return;
  const float rinv = 1.f / l;
  E* o = static_cast<E*>(a.o) + (row0 + i) * size_t(a.nh) * a.dv + h * a.dv;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < a.dv) Elem<E>::store(o + d, acc[d] * rinv);
  if (a.stats != nullptr) {
    const size_t s = (size_t(m) * a.nh + h) * a.T + i;
    a.stats[s] = mx;
    a.stats[size_t(a.M) * a.nh * a.T + s] = rinv;
  }
}

constexpr int WQ = 32;             // wide kernel: query rows per block
constexpr int WNT = WQ * LANES;    // its threads, LANES to a row
constexpr int WKT = 32;            // its keys staged in shared memory at a time

// The same function for q/k head widths DMAX < dh <= DKMAX: the LANES threads
// of a row each hold a CW-wide chunk of q_i and a DV / LANES-wide slice of
// the output; a score is the group_sum of their chunk dots.
template <typename E, int DV>
__global__ void __launch_bounds__(WNT) narrowband_attention_wide_kernel(const FwdArgs a) {
  constexpr int DVL = DV / LANES;
  __shared__ __align__(16) float sk[WKT][WROW];
  __shared__ __align__(16) float sv[WKT][DV];
  __shared__ float sm[WQ][WKT + 1];
  const int ntiles = (a.T + WQ - 1) / WQ;
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % a.nh;
  const int m = blockIdx.x / ntiles / a.nh;
  const int tid = threadIdx.x, lane = tid % LANES, row = tid / LANES;
  const int i = tile * WQ + row;
  const bool live = i < a.T;
  const size_t row0 = size_t(m) * a.T;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const float* mask = head_mask(a.mask, a.mask_heads, h, a.T);

  float qr[CW], acc[DVL];
#pragma unroll
  for (int d = 0; d < CW; ++d) {
    const int c = lane * CW + d;
    qr[d] = (live && c < a.dh) ? Elem<E>::load(q + (row0 + i) * a.ldq + h * a.dh + c) : 0.f;
  }
#pragma unroll
  for (int d = 0; d < DVL; ++d) acc[d] = 0.f;

  // pass 1: the row max (every thread computes scores: group_sum shuffles)
  float mx = -INFINITY;
  for (int j0 = 0; j0 < a.T; j0 += WKT) {
    const int kc = min(WKT, a.T - j0);
    __syncthreads();
    stage_wide<E, WKT, WNT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    if (mask != nullptr) stage_mask<WQ, WKT, WKT + 1, WNT>(&sm[0][0], mask, a.T, tile * WQ, j0, tid);
    __syncthreads();
    for (int j = 0; j < kc; ++j)
      mx = fmaxf(mx, wide_score(qr, &sk[j][lane * CWS], a.scale,
                                mask != nullptr ? &sm[row][j] : nullptr));
  }

  // pass 2: e with the final max, its float32 sum and round(e) v
  float l = 0.f;
  for (int j0 = 0; j0 < a.T; j0 += WKT) {
    const int kc = min(WKT, a.T - j0);
    __syncthreads();
    stage_wide<E, WKT, WNT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    stage_rows<E, DV, WKT, WNT>(sv, v, a.ldv, row0 + j0, h * a.dv, a.dv, kc, tid);
    if (mask != nullptr) stage_mask<WQ, WKT, WKT + 1, WNT>(&sm[0][0], mask, a.T, tile * WQ, j0, tid);
    __syncthreads();
    for (int j = 0; j < kc; ++j) {
      const float e = expf(wide_score(qr, &sk[j][lane * CWS], a.scale,
                                      mask != nullptr ? &sm[row][j] : nullptr) - mx);
      l += e;
      const float eb = Elem<E>::round(e);
#pragma unroll
      for (int d = 0; d < DVL; ++d) acc[d] = fmaf(eb, sv[j][lane * DVL + d], acc[d]);
    }
  }
  if (!live) return;
  const float rinv = 1.f / l;
  E* o = static_cast<E*>(a.o) + (row0 + i) * size_t(a.nh) * a.dv + h * a.dv;
#pragma unroll
  for (int d = 0; d < DVL; ++d)
    if (lane * DVL + d < a.dv) Elem<E>::store(o + lane * DVL + d, acc[d] * rinv);
  if (a.stats != nullptr && lane == 0) {
    const size_t s = (size_t(m) * a.nh + h) * a.T + i;
    a.stats[s] = mx;
    a.stats[size_t(a.M) * a.nh * a.T + s] = rinv;
  }
}

template <typename E>
int launch_wide(const FwdArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)a.M * a.nh * ((a.T + WQ - 1) / WQ);
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  switch (padded_v_width(a.dv)) {
    case 16: narrowband_attention_wide_kernel<E, 16><<<int(blocks), WNT, 0, stream>>>(a); break;
    case 32: narrowband_attention_wide_kernel<E, 32><<<int(blocks), WNT, 0, stream>>>(a); break;
    default: narrowband_attention_wide_kernel<E, 64><<<int(blocks), WNT, 0, stream>>>(a); break;
  }
  return int(cudaGetLastError());
}

template <typename E>
int launch(const FwdArgs& a, cudaStream_t stream) {
  if (a.dh > DMAX) return launch_wide<E>(a, stream);
  const long long blocks = (long long)a.M * a.nh * ((a.T + QT - 1) / QT);
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  switch (padded_width(a.dh, a.dv)) {
    case 16: narrowband_attention_kernel<E, 16><<<int(blocks), QT, 0, stream>>>(a); break;
    case 24: narrowband_attention_kernel<E, 24><<<int(blocks), QT, 0, stream>>>(a); break;
    case 32: narrowband_attention_kernel<E, 32><<<int(blocks), QT, 0, stream>>>(a); break;
    default: narrowband_attention_kernel<E, 64><<<int(blocks), QT, 0, stream>>>(a); break;
  }
  return int(cudaGetLastError());
}

}  // namespace

// o = attention(q, k, v, mask) on `stream`; stats (may be null) receives the
// row max and 1 / row sum for the backward. q, k, v, o are float32 (bf16
// inputs take narrowband_attention_tc.cu); ldq, ldk, ldv are the row strides
// of q, k, v in elements; mask is null or float32 [mask_heads, T, T] with
// mask_heads 1 or nh. Returns the CUDA error of the launch (0 on success).
extern "C" int nbss_narrowband_attention_fwd(const void* q, const void* k, const void* v,
                                             const void* mask, void* o, void* stats,
                                             long long ldq, long long ldk, long long ldv,
                                             int M, int T, int nh, int dh, int dv,
                                             int mask_heads, float scale, void* stream) {
  if (M < 1 || T < 1 || nh < 1 || dh < 1 || dv < 1 || dh > DKMAX || dv > DMAX ||
      (mask != nullptr && mask_heads != 1 && mask_heads != nh))
    return int(cudaErrorInvalidValue);
  const FwdArgs a{q, k, v, static_cast<const float*>(mask), o, static_cast<float*>(stats),
                  ldq, ldk, ldv, M, T, nh, dh, dv, mask_heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch<float>(a, s);
}

// The largest q/k head width the kernels take.
extern "C" int nbss_narrowband_attention_max_width() { return DKMAX; }

// The largest v head width the kernels take.
extern "C" int nbss_narrowband_attention_max_v_width() { return DMAX; }
