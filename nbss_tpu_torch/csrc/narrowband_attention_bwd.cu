// Narrow-band multi-head attention, backward, for Hopper (sm_90a), float32:
// fp32 FMA on the CUDA cores, since no tensor-core product keeps float32's
// digits. bf16 inputs take narrowband_attention_bwd_tc.cu (bf16 tensor
// cores).
//
// The adjoint of narrowband_attention.cu for a cotangent g of o, at the
// Pallas kernel's rounding points. With the forward's row max m and
// rinv = 1 / sum(e) (its `stats`), e = exp(s - m) recomputed from q, k and
// the mask, and round() to the inputs' type:
//
//     g'  = round(g * rinv)                      [T, dv] a head
//     dV  = round(e)^T g'
//     dP' = g' V^T                               (= dP * rinv)
//     delta = rowsum(dP' o e) * rinv
//     dS  = round(e o (dP' - delta) * scale)
//     dQ  = dS K ;  dK = dS^T Q
//
// with float32 sums. dq, dk and dv are written in the inputs' type; the
// mask gets no gradient.
//
// Replaces the Pallas TPU kernel _fused_backward (_bwd_kernel,
// _bwd_kernel_nomask) in nbss_tpu/ops/attention.py.
//
// What bounds it on an H100: at the training shape (M = 1032, T = 251,
// nh = 4, dh = dv = 24, float32) the function reads q, k, v, g and writes
// dq, dk, dv, 696 MB (0.21 ms at 3.35 TB/s), and does five [T, T] products, 62
// GFLOP (63 us at the tensor-core rate). These kernels run on the CUDA
// cores in float32 and recompute e where they need it, about 110 GFLOP of
// float32 FMA, a 1.7 ms floor at 67 TFLOP/s. Two launches, no atomics, so
// two calls on the same inputs give the same bits:
//
//   1. one block per (sequence, head, 64 query rows), a thread per row, K,
//      V and the mask staged 32 keys at a time: a first pass over the keys
//      forms delta (written to a [M, nh, T] float32 workspace), a second dS
//      and dQ, with q_i, g'_i and dq_i in registers;
//   2. one block per (sequence, head, 64 keys), a thread per key, Q, g', the
//      row statistics, delta and the mask staged 32 query rows at a time:
//      one pass over the queries forms e, dP' and dS again and sums dK and
//      dV, with k_j, v_j, dk_j and dv_j in registers.
//
// Both form s and dP' with the same dot() (narrowband_attention.cuh), so
// their e and dS agree bit for bit. Head widths are padded as in the
// forward; any M, T >= 1 is taken. q/k heads wider than 64 (up to 256) take
// two wide kernels of the same structure with four threads to a row or key,
// as the forward's wide kernel; they form s and dP' with wide_score() and
// group_sum(), the forward's own order of sums.

#include <climits>
#include <cmath>

#include "narrowband_attention.cuh"

namespace {

using namespace nbss_attn;

constexpr int QT = 64;  // kernel 1: query rows (threads) per block
constexpr int KT = 32;  // kernel 1: keys staged at a time
constexpr int KB = 64;  // kernel 2: keys (threads) per block
constexpr int QB = 32;  // kernel 2: query rows staged at a time

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;   // null, or [mask_heads, T, T]
  const void* g;       // [M, T, nh * dv], contiguous
  const float* stats;  // [2, M, nh, T]: row max, 1 / row sum
  void* dq;            // [M, T, nh * dh], contiguous
  void* dk;            // [M, T, nh * dh], contiguous
  void* dv;            // [M, T, nh * dv], contiguous
  float* delta;        // [M, nh, T] workspace
  long long ldq, ldk, ldv;
  int M, T, nh, dh, dvw, mask_heads;
  float scale;
};

template <typename E, int D>
__global__ void __launch_bounds__(QT) narrowband_attention_bwd_dq(const BwdArgs a) {
  __shared__ __align__(16) float sk[KT][D];
  __shared__ __align__(16) float sv[KT][D];
  __shared__ float sm[QT][KT + 1];
  const int ntiles = (a.T + QT - 1) / QT;
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % a.nh;
  const int m = blockIdx.x / ntiles / a.nh;
  const int tid = threadIdx.x;
  const int i = tile * QT + tid;
  const bool live = i < a.T;
  const size_t row0 = size_t(m) * a.T;
  const size_t srow = (size_t(m) * a.nh + h) * a.T;  // this head's row in stats / delta
  const size_t nstat = size_t(a.M) * a.nh * a.T;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const E* g = static_cast<const E*>(a.g);
  const float* mask = head_mask(a.mask, a.mask_heads, h, a.T);

  const float mx = live ? a.stats[srow + i] : 0.f;
  const float rinv = live ? a.stats[nstat + srow + i] : 0.f;
  float qr[D], gp[D], dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = (live && d < a.dh) ? Elem<E>::load(q + (row0 + i) * a.ldq + h * a.dh + d) : 0.f;
    gp[d] = (live && d < a.dvw)
                ? Elem<E>::round(
                      Elem<E>::load(g + (row0 + i) * size_t(a.nh) * a.dvw + h * a.dvw + d) * rinv)
                : 0.f;
    dq[d] = 0.f;
  }

  // pass 1: delta = rowsum(dP' o e) * rinv
  float acc = 0.f;
  for (int j0 = 0; j0 < a.T; j0 += KT) {
    const int kc = min(KT, a.T - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<E, D, KT, QT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    stage_rows<E, D, KT, QT>(sv, v, a.ldv, row0 + j0, h * a.dvw, a.dvw, kc, tid);
    if (mask != nullptr) stage_mask<QT, KT, KT + 1, QT>(&sm[0][0], mask, a.T, tile * QT, j0, tid);
    __syncthreads();
    if (live)
      for (int j = 0; j < kc; ++j) {
        const float e = expf(
            score<D>(qr, sk[j], a.scale, mask != nullptr ? &sm[tid][j] : nullptr) - mx);
        acc += dot<D>(gp, sv[j]) * e;
      }
  }
  const float delta = acc * rinv;
  if (live) a.delta[srow + i] = delta;

  // pass 2: dS and dQ
  for (int j0 = 0; j0 < a.T; j0 += KT) {
    const int kc = min(KT, a.T - j0);
    __syncthreads();
    stage_rows<E, D, KT, QT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    stage_rows<E, D, KT, QT>(sv, v, a.ldv, row0 + j0, h * a.dvw, a.dvw, kc, tid);
    if (mask != nullptr) stage_mask<QT, KT, KT + 1, QT>(&sm[0][0], mask, a.T, tile * QT, j0, tid);
    __syncthreads();
    if (live)
      for (int j = 0; j < kc; ++j) {
        const float e = expf(
            score<D>(qr, sk[j], a.scale, mask != nullptr ? &sm[tid][j] : nullptr) - mx);
        const float ds = Elem<E>::round(e * (dot<D>(gp, sv[j]) - delta) * a.scale);
#pragma unroll
        for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, sk[j][d], dq[d]);
      }
  }
  if (!live) return;
  E* out = static_cast<E*>(a.dq) + (row0 + i) * size_t(a.nh) * a.dh + h * a.dh;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < a.dh) Elem<E>::store(out + d, dq[d]);
}

template <typename E, int D>
__global__ void __launch_bounds__(KB) narrowband_attention_bwd_dkdv(const BwdArgs a) {
  __shared__ __align__(16) float sq[QB][D];
  __shared__ __align__(16) float sg[QB][D];  // g' rows
  __shared__ float smx[QB], sdl[QB];
  __shared__ float sm[QB][KB];  // mask tile: thread j reads column j
  const int ntiles = (a.T + KB - 1) / KB;
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % a.nh;
  const int m = blockIdx.x / ntiles / a.nh;
  const int tid = threadIdx.x;
  const int j = tile * KB + tid;
  const bool live = j < a.T;
  const size_t row0 = size_t(m) * a.T;
  const size_t srow = (size_t(m) * a.nh + h) * a.T;
  const size_t nstat = size_t(a.M) * a.nh * a.T;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const E* g = static_cast<const E*>(a.g);
  const float* mask = head_mask(a.mask, a.mask_heads, h, a.T);
  const size_t ldg = size_t(a.nh) * a.dvw;

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = (live && d < a.dh) ? Elem<E>::load(k + (row0 + j) * a.ldk + h * a.dh + d) : 0.f;
    vr[d] = (live && d < a.dvw) ? Elem<E>::load(v + (row0 + j) * a.ldv + h * a.dvw + d) : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  for (int i0 = 0; i0 < a.T; i0 += QB) {
    const int qc = min(QB, a.T - i0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<E, D, QB, KB>(sq, q, a.ldq, row0 + i0, h * a.dh, a.dh, qc, tid);
    for (int idx = tid; idx < QB * D; idx += KB) {
      const int r = idx / D, d = idx % D;
      sg[r][d] = (r < qc && d < a.dvw)
                     ? Elem<E>::round(Elem<E>::load(g + (row0 + i0 + r) * ldg + h * a.dvw + d) *
                                      a.stats[nstat + srow + i0 + r])
                     : 0.f;
    }
    if (tid < QB) {
      smx[tid] = tid < qc ? a.stats[srow + i0 + tid] : 0.f;
      sdl[tid] = tid < qc ? a.delta[srow + i0 + tid] : 0.f;
    }
    if (mask != nullptr) stage_mask<QB, KB, KB, KB>(&sm[0][0], mask, a.T, i0, tile * KB, tid);
    __syncthreads();
    if (live)
      for (int i = 0; i < qc; ++i) {
        const float e = expf(
            score<D>(kr, sq[i], a.scale, mask != nullptr ? &sm[i][tid] : nullptr) - smx[i]);
        const float eb = Elem<E>::round(e);
        const float ds = Elem<E>::round(e * (dot<D>(vr, sg[i]) - sdl[i]) * a.scale);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv[d] = fmaf(eb, sg[i][d], dv[d]);
          dk[d] = fmaf(ds, sq[i][d], dk[d]);
        }
      }
  }
  if (!live) return;
  E* outk = static_cast<E*>(a.dk) + (row0 + j) * size_t(a.nh) * a.dh + h * a.dh;
  E* outv = static_cast<E*>(a.dv) + (row0 + j) * ldg + h * a.dvw;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d < a.dh) Elem<E>::store(outk + d, dk[d]);
    if (d < a.dvw) Elem<E>::store(outv + d, dv[d]);
  }
}

constexpr int WQ = 32;             // wide dQ kernel: query rows per block
constexpr int WKB = 32;            // wide dK/dV kernel: keys per block
constexpr int WNT = 32 * LANES;    // threads of either, LANES to a row
constexpr int WT = 32;             // keys (dQ) or query rows (dK/dV) staged at a time

// Kernel 1 for q/k head widths DMAX < dh <= DKMAX: the LANES threads of a
// query row each hold a CW-wide chunk of q_i and dq_i and a DV / LANES-wide
// slice of g'_i; the scores and g'_i . v_j are group_sums of their partials.
template <typename E, int DV>
__global__ void __launch_bounds__(WNT) narrowband_attention_bwd_dq_wide(const BwdArgs a) {
  constexpr int DVL = DV / LANES;
  __shared__ __align__(16) float sk[WT][WROW];
  __shared__ __align__(16) float sv[WT][DV];
  __shared__ float sm[WQ][WT + 1];
  const int ntiles = (a.T + WQ - 1) / WQ;
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % a.nh;
  const int m = blockIdx.x / ntiles / a.nh;
  const int tid = threadIdx.x, lane = tid % LANES, row = tid / LANES;
  const int i = tile * WQ + row;
  const bool live = i < a.T;
  const size_t row0 = size_t(m) * a.T;
  const size_t srow = (size_t(m) * a.nh + h) * a.T;
  const size_t nstat = size_t(a.M) * a.nh * a.T;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const E* g = static_cast<const E*>(a.g);
  const float* mask = head_mask(a.mask, a.mask_heads, h, a.T);

  const float mx = live ? a.stats[srow + i] : 0.f;
  const float rinv = live ? a.stats[nstat + srow + i] : 0.f;
  float qr[CW], dq[CW], gp[DVL];
#pragma unroll
  for (int d = 0; d < CW; ++d) {
    const int c = lane * CW + d;
    qr[d] = (live && c < a.dh) ? Elem<E>::load(q + (row0 + i) * a.ldq + h * a.dh + c) : 0.f;
    dq[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DVL; ++d) {
    const int c = lane * DVL + d;
    gp[d] = (live && c < a.dvw)
                ? Elem<E>::round(
                      Elem<E>::load(g + (row0 + i) * size_t(a.nh) * a.dvw + h * a.dvw + c) * rinv)
                : 0.f;
  }

  // pass 1: delta = rowsum(dP' o e) * rinv
  float acc = 0.f;
  for (int j0 = 0; j0 < a.T; j0 += WT) {
    const int kc = min(WT, a.T - j0);
    __syncthreads();
    stage_wide<E, WT, WNT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    stage_rows<E, DV, WT, WNT>(sv, v, a.ldv, row0 + j0, h * a.dvw, a.dvw, kc, tid);
    if (mask != nullptr) stage_mask<WQ, WT, WT + 1, WNT>(&sm[0][0], mask, a.T, tile * WQ, j0, tid);
    __syncthreads();
    for (int j = 0; j < kc; ++j) {
      const float e = expf(wide_score(qr, &sk[j][lane * CWS], a.scale,
                                      mask != nullptr ? &sm[row][j] : nullptr) - mx);
      acc += group_sum(dot<DVL>(gp, &sv[j][lane * DVL])) * e;
    }
  }
  const float delta = acc * rinv;
  if (live && lane == 0) a.delta[srow + i] = delta;

  // pass 2: dS and dQ
  for (int j0 = 0; j0 < a.T; j0 += WT) {
    const int kc = min(WT, a.T - j0);
    __syncthreads();
    stage_wide<E, WT, WNT>(sk, k, a.ldk, row0 + j0, h * a.dh, a.dh, kc, tid);
    stage_rows<E, DV, WT, WNT>(sv, v, a.ldv, row0 + j0, h * a.dvw, a.dvw, kc, tid);
    if (mask != nullptr) stage_mask<WQ, WT, WT + 1, WNT>(&sm[0][0], mask, a.T, tile * WQ, j0, tid);
    __syncthreads();
    for (int j = 0; j < kc; ++j) {
      const float e = expf(wide_score(qr, &sk[j][lane * CWS], a.scale,
                                      mask != nullptr ? &sm[row][j] : nullptr) - mx);
      const float ds =
          Elem<E>::round(e * (group_sum(dot<DVL>(gp, &sv[j][lane * DVL])) - delta) * a.scale);
#pragma unroll
      for (int d = 0; d < CW; ++d) dq[d] = fmaf(ds, sk[j][lane * CWS + d], dq[d]);
    }
  }
  if (!live) return;
  E* out = static_cast<E*>(a.dq) + (row0 + i) * size_t(a.nh) * a.dh + h * a.dh;
#pragma unroll
  for (int d = 0; d < CW; ++d)
    if (lane * CW + d < a.dh) Elem<E>::store(out + lane * CW + d, dq[d]);
}

// Kernel 2 for DMAX < dh <= DKMAX: the LANES threads of a key each hold a
// CW-wide chunk of k_j and dk_j and a DV / LANES-wide slice of v_j and dv_j.
template <typename E, int DV>
__global__ void __launch_bounds__(WNT) narrowband_attention_bwd_dkdv_wide(const BwdArgs a) {
  constexpr int DVL = DV / LANES;
  __shared__ __align__(16) float sq[WT][WROW];
  __shared__ __align__(16) float sg[WT][DV];  // g' rows
  __shared__ float smx[WT], sdl[WT];
  __shared__ float sm[WT][WKB];  // mask tile: the threads of key j read column j
  const int ntiles = (a.T + WKB - 1) / WKB;
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % a.nh;
  const int m = blockIdx.x / ntiles / a.nh;
  const int tid = threadIdx.x, lane = tid % LANES, col = tid / LANES;
  const int j = tile * WKB + col;
  const bool live = j < a.T;
  const size_t row0 = size_t(m) * a.T;
  const size_t srow = (size_t(m) * a.nh + h) * a.T;
  const size_t nstat = size_t(a.M) * a.nh * a.T;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const E* g = static_cast<const E*>(a.g);
  const float* mask = head_mask(a.mask, a.mask_heads, h, a.T);
  const size_t ldg = size_t(a.nh) * a.dvw;

  float kr[CW], dk[CW], vr[DVL], dv[DVL];
#pragma unroll
  for (int d = 0; d < CW; ++d) {
    const int c = lane * CW + d;
    kr[d] = (live && c < a.dh) ? Elem<E>::load(k + (row0 + j) * a.ldk + h * a.dh + c) : 0.f;
    dk[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DVL; ++d) {
    const int c = lane * DVL + d;
    vr[d] = (live && c < a.dvw) ? Elem<E>::load(v + (row0 + j) * a.ldv + h * a.dvw + c) : 0.f;
    dv[d] = 0.f;
  }

  for (int i0 = 0; i0 < a.T; i0 += WT) {
    const int qc = min(WT, a.T - i0);
    __syncthreads();
    stage_wide<E, WT, WNT>(sq, q, a.ldq, row0 + i0, h * a.dh, a.dh, qc, tid);
    for (int idx = tid; idx < WT * DV; idx += WNT) {
      const int r = idx / DV, d = idx % DV;
      sg[r][d] = (r < qc && d < a.dvw)
                     ? Elem<E>::round(Elem<E>::load(g + (row0 + i0 + r) * ldg + h * a.dvw + d) *
                                      a.stats[nstat + srow + i0 + r])
                     : 0.f;
    }
    if (tid < WT) {
      smx[tid] = tid < qc ? a.stats[srow + i0 + tid] : 0.f;
      sdl[tid] = tid < qc ? a.delta[srow + i0 + tid] : 0.f;
    }
    if (mask != nullptr) stage_mask<WT, WKB, WKB, WNT>(&sm[0][0], mask, a.T, i0, tile * WKB, tid);
    __syncthreads();
    for (int i = 0; i < qc; ++i) {
      const float e = expf(wide_score(kr, &sq[i][lane * CWS], a.scale,
                                      mask != nullptr ? &sm[i][col] : nullptr) - smx[i]);
      const float eb = Elem<E>::round(e);
      const float ds =
          Elem<E>::round(e * (group_sum(dot<DVL>(vr, &sg[i][lane * DVL])) - sdl[i]) * a.scale);
#pragma unroll
      for (int d = 0; d < DVL; ++d) dv[d] = fmaf(eb, sg[i][lane * DVL + d], dv[d]);
#pragma unroll
      for (int d = 0; d < CW; ++d) dk[d] = fmaf(ds, sq[i][lane * CWS + d], dk[d]);
    }
  }
  if (!live) return;
  E* outk = static_cast<E*>(a.dk) + (row0 + j) * size_t(a.nh) * a.dh + h * a.dh;
  E* outv = static_cast<E*>(a.dv) + (row0 + j) * ldg + h * a.dvw;
#pragma unroll
  for (int d = 0; d < CW; ++d)
    if (lane * CW + d < a.dh) Elem<E>::store(outk + lane * CW + d, dk[d]);
#pragma unroll
  for (int d = 0; d < DVL; ++d)
    if (lane * DVL + d < a.dvw) Elem<E>::store(outv + lane * DVL + d, dv[d]);
}

template <typename E, int DV>
int launch_wide(const BwdArgs& a, cudaStream_t stream) {
  const long long per_head = (long long)a.M * a.nh;
  const long long blocks_q = per_head * ((a.T + WQ - 1) / WQ);
  const long long blocks_k = per_head * ((a.T + WKB - 1) / WKB);
  if (blocks_q > INT_MAX || blocks_k > INT_MAX) return int(cudaErrorInvalidValue);
  narrowband_attention_bwd_dq_wide<E, DV><<<int(blocks_q), WNT, 0, stream>>>(a);
  const int err = int(cudaGetLastError());
  if (err != 0) return err;
  narrowband_attention_bwd_dkdv_wide<E, DV><<<int(blocks_k), WNT, 0, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename E, int D>
int launch_width(const BwdArgs& a, cudaStream_t stream) {
  const long long per_head = (long long)a.M * a.nh;
  const long long blocks_q = per_head * ((a.T + QT - 1) / QT);
  const long long blocks_k = per_head * ((a.T + KB - 1) / KB);
  if (blocks_q > INT_MAX || blocks_k > INT_MAX) return int(cudaErrorInvalidValue);
  narrowband_attention_bwd_dq<E, D><<<int(blocks_q), QT, 0, stream>>>(a);
  const int err = int(cudaGetLastError());
  if (err != 0) return err;
  narrowband_attention_bwd_dkdv<E, D><<<int(blocks_k), KB, 0, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename E>
int launch(const BwdArgs& a, cudaStream_t stream) {
  if (a.dh > DMAX) switch (padded_v_width(a.dvw)) {
      case 16: return launch_wide<E, 16>(a, stream);
      case 32: return launch_wide<E, 32>(a, stream);
      default: return launch_wide<E, 64>(a, stream);
    }
  switch (padded_width(a.dh, a.dvw)) {
    case 16: return launch_width<E, 16>(a, stream);
    case 24: return launch_width<E, 24>(a, stream);
    case 32: return launch_width<E, 32>(a, stream);
    default: return launch_width<E, 64>(a, stream);
  }
}

}  // namespace

// (dq, dk, dv) of the attention for the cotangent g, on `stream`. stats: the
// [2, M, nh, T] row max and 1 / row sum that nbss_narrowband_attention_fwd
// wrote for the same q, k and mask; delta: a [M, nh, T] float32 workspace.
// q, k, v, g, dq, dk, dv are float32 (bf16 inputs take
// narrowband_attention_bwd_tc.cu); q, k, v
// rows lie ldq, ldk, ldv elements apart, g, dq, dk, dv are contiguous.
// Returns the CUDA error of the launches (0 on success).
extern "C" int nbss_narrowband_attention_bwd(const void* q, const void* k, const void* v,
                                             const void* mask, const void* g,
                                             const void* stats, void* dq, void* dk, void* dv,
                                             void* delta, long long ldq, long long ldk,
                                             long long ldv, int M, int T, int nh, int dh,
                                             int dvw, int mask_heads, float scale,
                                             void* stream) {
  if (M < 1 || T < 1 || nh < 1 || dh < 1 || dvw < 1 || dh > DKMAX || dvw > DMAX ||
      (mask != nullptr && mask_heads != 1 && mask_heads != nh))
    return int(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, static_cast<const float*>(mask), g,
                  static_cast<const float*>(stats), dq, dk, dv, static_cast<float*>(delta),
                  ldq, ldk, ldv, M, T, nh, dh, dvw, mask_heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch<float>(a, s);
}
