// Narrow-band attention block, forward and backward, on Hopper's warpgroup
// tensor cores (sm_90a: wgmma.mma_async, cp.async.bulk copies completed on
// mbarriers), for the shapes attention_block_tc.cu and attention_block_bwd_tc.cu
// cannot hold: H = 192 (SpatialNet-large, NBC2-large) at any T, and H = 96 at
// T > 256. Those two keep H = 96 with T <= 256; float32 inputs at these shapes
// take attention_block_wide.cu.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels _fused_block / _kernel
// and _fused_block_bwd / _bwd_kernel in nbss_tpu/ops/attention_block.py (which
// pad T to a multiple of 128 and mask the padding through the pad lane; here
// the ragged key edge is masked by index). The rounding points are those of
// ops/attention_block.py reference and reference_bwd:
//
//   forward:  xa, t = xa A_h, vo = xa Wvo_h and e = exp(s - rowmax s) rounded
//             to bf16, the row max exact before any e is formed; pv summed in
//             float32 and divided by the float32 sum of the rounded e; the
//             heads summed in float32 in head order; y = rnd(acc + c + x).
//   backward: t, vo, g' = rnd(g / sum(e)) with the sum of the UNROUNDED e (the
//             backward's own statistics, not the forward's), rnd(e) where it
//             meets g', dvo, dS = rnd(e (dP - delta)) with delta = sum(dP e) /
//             sum(e) over the unrounded e, and dt rounded; dP, delta, dxa and
//             the weight cotangents float32.
//
// The kernels compute the folded function: per head t = xa A_h (H + 2 wide,
// its lane H the float32 bias tq) and vo = xa Wvo_h; they never unfold it
// into per-head q, k, v.
//
// What bounds it on an H100: arithmetic. At SpatialNet-large's serving shape
// (M = 2064, T = 251, H = 192, 4 heads) the folded forward is about 0.7
// TFLOP (a 0.72 ms floor at 989 TFLOP/s); x and y are 398 MB (0.12 ms). The
// mma.sync route this file replaced ran it at 13% of the tensor cores' peak,
// with every head's t and vo written to and streamed back from device memory
// as row arrays, and the kept scores of long sequences in a global workspace.
//
// What the design does about it:
//   * every product is a warpgroup wgmma (m64n32k16 / m64n64k16, bf16 in,
//     float32 out), its operands in shared memory as 128-byte (H = 192) or
//     64-byte (H = 96) swizzled panels (wgmma_bf16.cuh) that cp.async.bulk
//     copies fill straight from device memory: a producer warpgroup (one
//     thread issuing, its registers given to the consumers by setmaxnreg)
//     keeps a ring of stages in flight behind full / empty mbarriers while
//     two consumer warpgroups (64 query or key rows each) compute;
//   * the operands that go through device memory are written once, already
//     in that swizzled panel layout ("images", 64-row tiles, rows past T
//     zero), so a load is one bulk copy a tile or panel;
//   * t never leaves the chip in the forward: each warpgroup forms t for its
//     64 queries from its xa tile and rnd(A_h) (streamed through the ring),
//     keeps it as wgmma A fragments in registers, and feeds the scores from
//     them; vo is formed once a head and sequence by wide_vo and read back
//     by every query block of the sequence;
//   * no kept-score workspace: the exact row max comes from a first pass
//     over the keys, and a second pass recomputes the scores, forms rnd(e)
//     in registers and feeds it as the register A operand of pv = rnd(e) vo,
//     as FlashAttention-3 does; the head sum stays in shared memory;
//   * the backward's score products take their A operand (the warpgroup's t,
//     g', xa or vo tile) from shared memory, so it streams 64-row stages
//     (N = 64) to read that operand half as often as 32-row ones would; the
//     forward's scores take t from registers and stream 32-row stages;
//   * no atomics: every sum has one owner or a fixed order, so two launches
//     give the same bits.
//
// Forward kernels, per chunk of sequences:
//   wide_prep   rnd(A_h), rnd(Wvo_h) images and the float32 bias vectors.
//   wide_ln     xa = rnd(LN(x)) image and tq = t[:, H] for every head.
//   wide_vo     vo = rnd(xa Wvo_h + Wvo_h[H]) images, Wvo_h resident.
//   wide_attn   a persistent grid over (sequence, 128 queries): per head t,
//               pass 1 (row max), pass 2 (rnd(e), sum, pv), the head sum;
//               y at the last head.
// Backward kernels (every sequence at once):
//   wide_prep, wide_ln, wide_vo as above, then
//   wide_bwd_query  per (sequence, 128 queries) and head: t (its image
//               written), pass 1 the row max and sum of exp (online), g' (its
//               image written), pass 2 delta from dP = g' vo^T, pass 3 dS and
//               dt = dS xa (its image, the row max, delta and rnd(rowsum dS)
//               written).
//   wide_bwd_key    per (sequence, 128 keys): pass A per head dvo = rnd(e)^T
//               g' (its image written); pass B per head dS^T from e^T and
//               dP^T = vo g'^T, dxa += dS^T t summed over the heads in
//               registers; dxa written once. The queries' statistics ride in
//               the ring behind their t tiles.
//   wide_bwd_dxa    dxa += sum_h dt_h A_h^T + dvo_h Wvo_h^T (one product over
//               the 2 nh H channels) + dt[:, H] A_h[:H, H].
//   wide_ln_bwd     the LayerNorm adjoint: dx, and dln, dc per block.
//   wide_bwd_weights / wide_bwd_extras / wide_bwd_reduce   dA_h = xa^T dt,
//               dWvo_h = xa^T dvo over fixed slices of 64-row tiles (wgmma,
//               xa read transposed), the ones lane's row and column sums, and
//               every float32 partial summed in a fixed order.
//
// H = 96 or 192; any nh that divides H, T >= 1 and M >= 1.

#include <algorithm>

#include "wgmma_bf16.cuh"

namespace {

using namespace nbss_wgmma;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;
constexpr int TR = 64;          // rows a tile (and a warpgroup's query or key rows)
constexpr int HR = 32;          // rows a streamed stage
constexpr int NCW = 256;        // consumer threads: two warpgroups
constexpr int NTH = NCW + 128;  // and a producer warpgroup (one thread of it issues the copies)
constexpr int NVO = NCW + 32;   // wide_vo's threads: two consumer warpgroups, a producer warp
constexpr int MAX_STAGES = 16;

template <int H_>
struct Geo {
  static constexpr int H = H_;
  static constexpr int PW = H / 3;              // columns a panel
  static constexpr int PB = 2 * PW;             // bytes a panel row
  static constexpr int KSP = PW / 16;           // k-steps a panel
  static constexpr int KS = H / 16;             // k-steps over the channels
  static constexpr int ACC = PW / 2;            // floats of a panel-wide accumulator
  static constexpr int TILE_B = 3 * TR * PB;    // a 64-row tile
  static constexpr int HALF_B = 3 * HR * PB;    // a 32-row stage
  static constexpr int WPANEL_B = H * PB;       // a weight panel (H rows)
  static constexpr int W_B = 3 * WPANEL_B;      // a weight image
  static constexpr int VEC = 3 * H + 8;         // abias, wbias, acol, A[H][H]
  static_assert(PW == 32 || PW == 64, "H = 96 or 192");
};

__host__ __device__ constexpr size_t align1k(size_t b) { return (b + 1023) & ~size_t(1023); }

template <typename V>
__host__ __device__ constexpr V vmin(V a, V b) { return a < b ? a : b; }

// The first 1024-byte boundary of dynamic shared memory (swizzled panels
// start on one); every layout below reserves the 1024 bytes this may skip.
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// The A fragments (16 columns each) of a [64, R] accumulator, rounded to bf16.
template <int R>
__device__ __forceinline__ void frags(uint32_t (&a)[R / 16][4], const float (&d)[R / 2]) {
#pragma unroll
  for (int ks = 0; ks < R / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = pack(d[8 * ks + 2 * r], d[8 * ks + 2 * r + 1]);
}

// Byte offset of (row r, column c) in an image of R-row panels.
template <int H, int R>
__host__ __device__ __forceinline__ uint32_t img_off(int r, int c) {
  using G = Geo<H>;
  return uint32_t(c / G::PW) * R * G::PB + swz<G::PB>(uint32_t(r) * G::PB + uint32_t(c % G::PW) * 2);
}

// K-major operand of R rows a panel at k-step kk (16 channels).
template <int H, int R>
__device__ __forceinline__ uint64_t kdesc(const unsigned char* base, int kk) {
  using G = Geo<H>;
  return desc_plus(desc<G::PB>(base, 16), (kk / G::KSP) * R * G::PB + (kk % G::KSP) * 32);
}

// MN-major operand of R rows a panel (the rows are K): panel p, k-step kk (16 rows).
template <int H, int R>
__device__ __forceinline__ uint64_t mdesc(const unsigned char* base, int p, int kk) {
  using G = Geo<H>;
  return desc_plus(desc<G::PB>(base, R * G::PB), p * R * G::PB + kk * 16 * G::PB);
}

// Barrier of warpgroup w's 128 threads (ids 1 and 2; 0 is __syncthreads),
// its id a constant so that the register budget of setmaxnreg still holds.
__device__ __forceinline__ void wg_sync(int w) {
  if (w == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The ring of streamed stages: full (one producer arrival + bytes) and empty
// (one arrival per consumer warp) barriers, the stage counter s giving slot
// and parity.
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int n, bytes;
  __device__ unsigned char* slot(int s) const { return slots + size_t(s % n) * bytes; }
  // producer: wait for the slot to be free, announce `tx` bytes
  __device__ unsigned char* acquire(int s, uint32_t tx) const {
    if (s >= n) mbar_wait(&empty[s % n], ((s / n) - 1) & 1);
    mbar_expect_tx(&full[s % n], tx);
    return slot(s);
  }
  __device__ unsigned char* wait(int s) const {
    mbar_wait(&full[s % n], (s / n) & 1);
    return slot(s);
  }
  // consumer: every thread of the warp is past its reads of the slot
  __device__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s % n]);
  }
};

// Rows 32 q .. 32 q + 31 of image tile `tile` (all three panels) into a stage.
template <int H>
__device__ __forceinline__ void load_half(unsigned char* dst, const unsigned char* img, size_t tile,
                                          int q, uint64_t* bar) {
  using G = Geo<H>;
  const unsigned char* src = img + tile * G::TILE_B + (q & 1) * HR * G::PB;
#pragma unroll
  for (int p = 0; p < 3; ++p) bulk_load(dst + p * HR * G::PB, src + p * TR * G::PB, HR * G::PB, bar);
}

// Score registers of one stage of R rows: the scores, and dP where a pass
// forms both; KS k-steps of fragments they round to.
template <int R>
struct Sc1 {
  static constexpr int N = R, KS = R / 16;
  float s[R / 2];
  __device__ __forceinline__ void fence() { fence_regs(s); }
};
template <int R>
struct Sc2 {
  static constexpr int N = R, KS = R / 16;
  float s[R / 2], d[R / 2];
  __device__ __forceinline__ void fence() {
    fence_regs(s);
    fence_regs(d);
  }
};

// A pass over n stages of the ring. Stage q is P1 (products into the score
// registers, one committed group, its own waits for the ring included), the
// elementwise math on them and, with TWO, P2 (a product from the math's
// results, rounded into A fragments, into an accumulator; one group), each
// waited for in turn; done1(q) / done2(q) run once P1 / P2 of stage q have
// completed. The two consumer warpgroups of a block keep the tensor cores
// busy between them: overlapping a stage's math with the next stage's
// products inside a warpgroup, as FlashAttention-3 does, and products over
// two stages at a time were both slower in these kernels on the card.
template <bool TWO, typename Sc, typename P1, typename Math, typename P2, typename D1,
          typename D2>
__device__ __forceinline__ void run_stages(int n, P1 p1, Math math, P2 p2, D1 done1, D2 done2) {
  Sc sc;
  uint32_t f[Sc::KS][4];
  for (int q = 0; q < n; ++q) {
    p1(q, sc);
    wgmma_wait_all();
    sc.fence();
    done1(q);
    math(q, sc);
    if constexpr (TWO) {
      frags<Sc::N>(f, sc.s);
      p2(q, f);
      wgmma_wait_all();
#pragma unroll
      for (int k = 0; k < Sc::KS; ++k) fence_regs(f[k]);
      done2(q);
    }
  }
}

__device__ __forceinline__ void nothing(int) {}

// Shared-memory carve-up: fixed regions, then the ring, then the barriers.
template <int H>
struct Smem {
  int ring_off, nstages, bar_off, total;
  __host__ __device__ Smem(int fixed, int stage_bytes, int nbars_fixed) {
    ring_off = int(align1k(fixed));
    const int room = SMEM_MAX - 1024 - ring_off - 8 * (nbars_fixed + 2 * MAX_STAGES);
    nstages = vmin(MAX_STAGES, room / stage_bytes);
    bar_off = ring_off + nstages * stage_bytes;
    total = bar_off + 8 * (nbars_fixed + 2 * nstages) + 1024;
  }
};

// ---------------------------------------------------------------------------
// shared by the forward and the backward
// ---------------------------------------------------------------------------

// Per head: rnd(A_h[:H, :H]) and rnd(Wvo_h[:H, :H]) images (rows = input
// channel), and the float32 vectors abias = rnd(A_h[H, :H]), wbias =
// rnd(Wvo_h[H, :H]), acol = rnd(A_h[:H, H]) and rnd(A_h[H, H]).
template <int H>
__global__ void wide_prep(const float* __restrict__ A, const float* __restrict__ Wvo,
                          unsigned char* __restrict__ wimg, float* __restrict__ vecs) {
  using G = Geo<H>;
  constexpr int HA = H + 2;
  const int h = blockIdx.x;
  const float* Ah = A + size_t(h) * HA * HA;
  const float* Wh = Wvo + size_t(h) * HA * HA;
  unsigned char* ia = wimg + size_t(2 * h) * G::W_B;
  unsigned char* iw = ia + G::W_B;
  for (int idx = threadIdx.x; idx < H * H; idx += blockDim.x) {
    const int i = idx / H, k = idx % H;
    *reinterpret_cast<bf16*>(ia + img_off<H, H>(i, k)) = __float2bfloat16(Ah[i * HA + k]);
    *reinterpret_cast<bf16*>(iw + img_off<H, H>(i, k)) = __float2bfloat16(Wh[i * HA + k]);
  }
  float* v = vecs + size_t(h) * G::VEC;
  for (int n = threadIdx.x; n < H; n += blockDim.x) {
    v[n] = round_bf16(Ah[H * HA + n]);
    v[H + n] = round_bf16(Wh[H * HA + n]);
    v[2 * H + n] = round_bf16(Ah[n * HA + H]);
  }
  if (threadIdx.x < 8) v[3 * H + threadIdx.x] = threadIdx.x == 0 ? round_bf16(Ah[H * HA + H]) : 0.f;
}

// xa = rnd(LN(x)) image (rows past T zero) and tq[h][row] = rnd(xa .
// acol_h + A_h[H, H]): LPR = H / 24 lanes a padded row (32 / LPR rows a
// warp), each lane three 8-channel chunks.
template <int H>
__global__ void __launch_bounds__(256) wide_ln(const bf16* __restrict__ x,
                                               const float* __restrict__ ln,
                                               const float* __restrict__ vecs,
                                               unsigned char* __restrict__ ximg,
                                               float* __restrict__ tq, int mc, int T, int nh,
                                               float eps) {
  using G = Geo<H>;
  constexpr int LPR = H / 24;
  const int Tp = (T + TR - 1) / TR * TR;
  const long long rowsP = (long long)mc * Tp;
  const int lane = threadIdx.x % 32, sub = lane % LPR;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / LPR;
  const bool in = r < rowsP;
  const int m = in ? int(r / Tp) : 0, j = in ? int(r % Tp) : 0;
  const bool valid = in && j < T;
  auto rsum = [](float v) {
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  float v[3][8] = {};
  if (valid) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + ((size_t)m * T + j) * H + 8 * (sub + LPR * k));
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[k][e] = __bfloat162float(xv[e]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[k][e];
  const float mu = rsum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[k][e] -= mu;
      q += v[k][e] * v[k][e];
    }
  const float rs = rsqrtf(rsum(q) / H + eps);
  const size_t tile = (size_t)m * (Tp / TR) + j / TR;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c0 = 8 * (sub + LPR * k);
    uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[k][e] = valid ? round_bf16(v[k][e] * rs * ln[c0 + e] + ln[H + c0 + e]) : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) pk[e] = pack(v[k][2 * e], v[k][2 * e + 1]);
    if (in)
      *reinterpret_cast<uint4*>(ximg + tile * G::TILE_B + img_off<H, TR>(j % TR, c0)) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
  for (int h = 0; h < nh; ++h) {
    const float* acol = vecs + size_t(h) * G::VEC + 2 * H;
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) d = fmaf(v[k][e], acol[8 * (sub + LPR * k) + e], d);
    d = rsum(d);
    if (in && sub == 0) tq[size_t(h) * rowsP + r] = valid ? round_bf16(d + vecs[size_t(h) * G::VEC + 3 * H]) : 0.f;
  }
}

// Rounded bf16 pairs of a [64, H] accumulator (three panel-wide parts, plus
// bias[col] when given) into a TR-row image tile in shared memory.
template <int H>
__device__ __forceinline__ void store_tile(unsigned char* tile, const float (&acc)[3][Geo<H>::ACC],
                                           const float* bias, int wt) {
  using G = Geo<H>;
  const int g = (wt & 31) >> 2, t4 = wt & 3, r0 = 16 * (wt >> 5) + g;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < G::ACC / 4; ++j) {
      const int col = p * G::PW + 8 * j + 2 * t4;
      const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(tile + img_off<H, TR>(r0 + 8 * hf, col)) =
            pack(acc[p][4 * j + 2 * hf] + b0, acc[p][4 * j + 2 * hf + 1] + b1);
    }
}

// vo_h = rnd(xa Wvo_h + wbias_h) image tiles: block (bx, h) keeps rnd(Wvo_h)
// in shared memory and takes tiles bx, bx + gridDim.x, ..., its two
// warpgroups in turn; each tile out through a staged bulk store.
template <int H>
__global__ void __launch_bounds__(NVO, 1) wide_vo(const unsigned char* __restrict__ ximg,
                                                  const unsigned char* __restrict__ wimg,
                                                  const float* __restrict__ vecs,
                                                  unsigned char* __restrict__ vimg, int ntiles) {
  using G = Geo<H>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const Smem<H> L(G::W_B + 2 * G::TILE_B, G::TILE_B, 1);
  unsigned char* W = smem;
  unsigned char* OUT = smem + G::W_B;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const Ring ring{smem + L.ring_off, bars + 1, bars + 1 + L.nstages, L.nstages, G::TILE_B};
  const int h = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < L.nstages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= NCW) {  // producer
    if (tid == NCW) {
      mbar_expect_tx(&bars[0], G::W_B);
      bulk_load(W, wimg + size_t(2 * h + 1) * G::W_B, G::W_B, &bars[0]);
      int s = 0;
      for (int i = blockIdx.x; i < ntiles; i += gridDim.x, ++s)
        bulk_load(ring.acquire(s, G::TILE_B), ximg + size_t(i) * G::TILE_B, G::TILE_B,
                  &ring.full[s % ring.n]);
    }
    return;
  }
  const int w = tid >> 7, wt = tid & 127;
  const float* wbias = vecs + size_t(h) * G::VEC + H;
  unsigned char* out = OUT + w * G::TILE_B;
  mbar_wait(&bars[0], 0);
  for (int s = w, i = blockIdx.x + w * gridDim.x; i < ntiles; s += 2, i += 2 * gridDim.x) {
    const unsigned char* xs = ring.wait(s);
    float acc[3][G::ACC];
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int kk = 0; kk < G::KS; ++kk)
        mma_ss<G::PW, 0, 1>(acc[p], kdesc<H, TR>(xs, kk), mdesc<H, H>(W, p, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < 3; ++p) fence_regs(acc[p]);
    ring.release(s);
    if (wt == 0) bulk_store_wait_read();
    wg_sync(w);  // the last tile's store has read the staging
    store_tile<H>(out, acc, wbias, wt);
    fence_async_smem();
    wg_sync(w);
    if (wt == 0) bulk_store(vimg + (size_t(h) * ntiles + i) * G::TILE_B, out, G::TILE_B);
  }
  if (wt == 0) bulk_store_wait();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct AttnArgs {
  const unsigned char* ximg;  // [tiles] xa image
  const unsigned char* vimg;  // [nh][tiles] vo images
  const unsigned char* wimg;  // [nh][2] weight images
  const float* vecs;          // [nh][VEC]
  const float* tq;            // [nh][mc Tp]
  const bf16* x;              // [mc][T][H] this chunk's input
  const float* c;             // [H]
  bf16* y;                    // [mc][T][H]
  int mc, T, nh;
};

template <int H>
struct AttnSmem : Smem<H> {
  // head sums [2 warpgroups][H / 2 floats][128 threads], the xa tiles of the queries
  static constexpr int ACC_B = H / 2 * 128 * 4;
  __host__ __device__ AttnSmem() : Smem<H>(2 * ACC_B + 2 * Geo<H>::TILE_B, Geo<H>::HALF_B, 4) {}
};

// Issues the scores of the 64 queries of t (A fragments) against the 32 keys
// of a stage.
template <int H>
__device__ __forceinline__ void scores_rs(float (&sc)[16], const uint32_t (&tf)[Geo<H>::KS][4],
                                          const unsigned char* keys) {
#pragma unroll
  for (int kk = 0; kk < Geo<H>::KS; ++kk) mma_rs<HR, 0>(sc, tf[kk], kdesc<H, HR>(keys, kk), kk > 0);
}

// Keys >= T set to -inf, tq added.
template <int R>
__device__ __forceinline__ void mask_scores(float (&sc)[R / 2], int k0, int T, const float (&cq)[2],
                                            int t4) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = k0 + 8 * j + 2 * t4 + (e & 1) < T ? sc[4 * j + e] + cq[e >> 1] : -INFINITY;
}

// t = xa_q rnd(A_h) for a warpgroup's 64 queries (A: the xa tile Q, B: six
// stages of the A_h image, panel p and half kh of its rows each).
template <int H>
__device__ __forceinline__ void form_t(float (&ta)[3][Geo<H>::ACC], const unsigned char* Q,
                                       const Ring& ring, int& s) {
  using G = Geo<H>;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const unsigned char* ws = ring.wait(s);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < G::KS / 2; ++k)
        mma_ss<G::PW, 0, 1>(ta[p], kdesc<H, TR>(Q, kh * G::KS / 2 + k), mdesc<H, H / 2>(ws, 0, k),
                            kh > 0 || k > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ta[p]);
      ring.release(s++);
    }
}

// The producer's half of form_t: the six weight stages of head h.
template <int H>
__device__ __forceinline__ void push_weights(const Ring& ring, int& s, const unsigned char* wa) {
  using G = Geo<H>;
  constexpr int bytes = H / 2 * G::PB;
  for (int p = 0; p < 3; ++p)
    for (int kh = 0; kh < 2; ++kh, ++s)
      bulk_load(ring.acquire(s, bytes), wa + p * G::WPANEL_B + kh * bytes, bytes,
                &ring.full[s % ring.n]);
}

template <int H>
__device__ __forceinline__ void push_half(const Ring& ring, int& s, const unsigned char* img,
                                          size_t tile, int q) {
  load_half<H>(ring.acquire(s, Geo<H>::HALF_B), img, tile, q, &ring.full[s % ring.n]);
  ++s;
}

template <int H>
__global__ void __launch_bounds__(NTH, 1) wide_attn(const AttnArgs a) {
  using G = Geo<H>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const AttnSmem<H> L;
  float* ACC = reinterpret_cast<float*>(smem);
  unsigned char* QB = smem + 2 * L.ACC_B;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* qfull = bars;
  uint64_t* qempty = bars + 2;
  const Ring ring{smem + L.ring_off, bars + 4, bars + 4 + L.nstages, L.nstages, G::HALF_B};
  const int tid = threadIdx.x, T = a.T;
  const int ntile = (T + TR - 1) / TR, Tp = ntile * TR, nk = (T + HR - 1) / HR;
  const int nqb = (ntile + 1) / 2, items = a.mc * nqb;
  const size_t rowsP = size_t(a.mc) * Tp, ntiles = size_t(a.mc) * ntile;
  if (tid == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&qfull[w], 1);
      mbar_init(&qempty[w], 128);
    }
    for (int i = 0; i < L.nstages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NCW / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCW) {  // producer
    regs_producer();
    if (tid == NCW) {
      int s = 0, it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int m = item / nqb, qb = item % nqb;
        for (int w = 0; w < 2; ++w) {
          if (it > 0) mbar_wait(&qempty[w], (it - 1) & 1);
          mbar_expect_tx(&qfull[w], G::TILE_B);
          bulk_load(QB + w * G::TILE_B,
                    a.ximg + (size_t(m) * ntile + vmin(2 * qb + w, ntile - 1)) * G::TILE_B,
                    G::TILE_B, &qfull[w]);
        }
        for (int h = 0; h < a.nh; ++h) {
          push_weights<H>(ring, s, a.wimg + size_t(2 * h) * G::W_B);
          for (int q = 0; q < nk; ++q) push_half<H>(ring, s, a.ximg, size_t(m) * ntile + q / 2, q);
          const unsigned char* vh = a.vimg + size_t(h) * ntiles * G::TILE_B;
          for (int q = 0; q < nk; ++q) {
            push_half<H>(ring, s, a.ximg, size_t(m) * ntile + q / 2, q);
            push_half<H>(ring, s, vh, size_t(m) * ntile + q / 2, q);
          }
        }
      }
    }
  } else {  // consumers
    regs_consumer();
    const int w = tid >> 7, wt = tid & 127, lane = wt & 31;
    const int g = lane >> 2, t4 = lane & 3, rl = 16 * (wt >> 5) + g;  // rows rl, rl + 8 of the tile
    float* accs = ACC + size_t(w) * (H / 2) * 128 + wt;
    const unsigned char* Q = QB + w * G::TILE_B;
    int s = 0, it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int m = item / nqb, qt = 2 * (item % nqb) + w;
      const bool active = qt < ntile;
      const int q0 = qt * TR;
      mbar_wait(&qfull[w], it & 1);
      for (int h = 0; h < a.nh; ++h) {
        const float* vh = a.vecs + size_t(h) * G::VEC;
        float ta[3][G::ACC];
        form_t<H>(ta, Q, ring, s);
        if (h == a.nh - 1) mbar_arrive(&qempty[w]);
        uint32_t tf[G::KS][4];  // t = rnd(xa A_h + abias) as A fragments
#pragma unroll
        for (int kk = 0; kk < G::KS; ++kk) {
          const int p = kk / G::KSP, j0 = 2 * (kk % G::KSP), col = p * G::PW + 8 * j0 + 2 * t4;
          tf[kk][0] = pack(ta[p][4 * j0] + vh[col], ta[p][4 * j0 + 1] + vh[col + 1]);
          tf[kk][1] = pack(ta[p][4 * j0 + 2] + vh[col], ta[p][4 * j0 + 3] + vh[col + 1]);
          tf[kk][2] = pack(ta[p][4 * j0 + 4] + vh[col + 8], ta[p][4 * j0 + 5] + vh[col + 9]);
          tf[kk][3] = pack(ta[p][4 * j0 + 6] + vh[col + 8], ta[p][4 * j0 + 7] + vh[col + 9]);
        }
        float cq[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = q0 + rl + 8 * hf;
          cq[hf] = active && i < T ? a.tq[size_t(h) * rowsP + size_t(m) * Tp + i] : 0.f;
        }

        // pass 1: the exact row max
        float mx[2] = {-INFINITY, -INFINITY};
        const int s1 = s;
        run_stages<false, Sc1<HR>>(
            nk,
            [&](int q, Sc1<HR>& sc) {
              const unsigned char* ks = ring.wait(s1 + q);
              wgmma_fence();
              scores_rs<H>(sc.s, tf, ks);
              wgmma_commit();
            },
            [&](int q, Sc1<HR>& sc) {
              mask_scores<HR>(sc.s, q * HR, T, cq, t4);
#pragma unroll
              for (int e = 0; e < 16; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc.s[e]);
            },
            [&](int, uint32_t(&)[2][4]) {}, [&](int q) { ring.release(s1 + q); }, nothing);
        s += nk;
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);

        // pass 2: rnd(e), its sum, pv = rnd(e) vo (xa at s2 + 2q, vo at s2 + 2q + 1)
        float O[3][G::ACC];
        float l[2] = {0.f, 0.f};
        const int s2 = s;
        run_stages<true, Sc1<HR>>(
            nk,
            [&](int q, Sc1<HR>& sc) {
              const unsigned char* ks = ring.wait(s2 + 2 * q);
              wgmma_fence();
              scores_rs<H>(sc.s, tf, ks);
              wgmma_commit();
            },
            [&](int q, Sc1<HR>& sc) {
              mask_scores<HR>(sc.s, q * HR, T, cq, t4);
#pragma unroll
              for (int e = 0; e < 16; ++e) {
                sc.s[e] = round_bf16(ex2((sc.s[e] - mx[(e >> 1) & 1]) * LOG2E));
                l[(e >> 1) & 1] += sc.s[e];
              }
            },
            [&](int q, uint32_t (&f)[2][4]) {
              const unsigned char* vs = ring.wait(s2 + 2 * q + 1);
              wgmma_fence();
#pragma unroll
              for (int p = 0; p < 3; ++p)
#pragma unroll
                for (int ks = 0; ks < 2; ++ks)
                  mma_rs<G::PW, 1>(O[p], f[ks], mdesc<H, HR>(vs, p, ks), q > 0 || ks > 0);
              wgmma_commit();
            },
            [&](int q) { ring.release(s2 + 2 * q); }, [&](int q) { ring.release(s2 + 2 * q + 1); });
#pragma unroll
        for (int p = 0; p < 3; ++p) fence_regs(O[p]);
        s += 2 * nk;
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);

        // acc += pv / sum(e), in head order; at the last head y = rnd(acc + c + x)
        const bool last = h == a.nh - 1;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < G::ACC / 4; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int e0 = 4 * j + 2 * hf, slot = p * G::ACC + e0;
              float v0 = O[p][e0] / l[hf], v1 = O[p][e0 + 1] / l[hf];
              if (h > 0) {
                v0 = accs[slot * 128] + v0;
                v1 = accs[(slot + 1) * 128] + v1;
              }
              if (!last) {
                accs[slot * 128] = v0;
                accs[(slot + 1) * 128] = v1;
              } else {
                const int i = q0 + rl + 8 * hf, col = p * G::PW + 8 * j + 2 * t4;
                if (active && i < T) {
                  const size_t o = (size_t(m) * T + i) * H + col;
                  const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(a.x + o);
                  *reinterpret_cast<__nv_bfloat162*>(a.y + o) = __floats2bfloat162_rn(
                      (v0 + a.c[col]) + __bfloat162float(xv.x), (v1 + a.c[col + 1]) + __bfloat162float(xv.y));
                }
              }
            }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const unsigned char* ximg;  // [tiles] xa
  const unsigned char* vimg;  // [nh][tiles] vo
  const unsigned char* wimg;  // [nh][2] rnd(A_h), rnd(Wvo_h)
  const float* vecs;          // [nh][VEC]
  const float* tq;            // [nh][rowsP] t[:, H]
  const bf16* g;              // [M][T][H]
  unsigned char* timg;        // [nh][tiles] t
  unsigned char* gimg;        // [nh][tiles] g'
  unsigned char* dimg;        // [nh][tiles] dt
  unsigned char* oimg;        // [nh][tiles] dvo
  float* ms;                  // [nh][rowsP] row max of the scores
  float* dl;                  // [nh][rowsP] delta
  float* dth;                 // [nh][rowsP] rnd(row sum of dS)
  float* dxa;                 // [M T][H]
  int M, T, nh;
};

// The backward streams whole 64-row tiles: its score products take A from
// shared memory, and N = 64 halves how often that A is read per product.
template <int H>
struct QuerySmem : Smem<H> {
  // the t and g' tiles of each warpgroup's queries, each row's 1 / sum(e)
  __host__ __device__ QuerySmem() : Smem<H>(4 * Geo<H>::TILE_B + 2 * TR * 4, Geo<H>::TILE_B, 0) {}
};

// Issues the products of a 64-row tile A (K-major over the channels) and the
// TR rows of a stage.
template <int H>
__device__ __forceinline__ void scores_ss(float (&sc)[TR / 2], const unsigned char* A,
                                          const unsigned char* rows) {
#pragma unroll
  for (int kk = 0; kk < Geo<H>::KS; ++kk)
    mma_ss<TR, 0, 0>(sc, kdesc<H, TR>(A, kk), kdesc<H, TR>(rows, kk), kk > 0);
}

// t = xa_q rnd(A_h) for warpgroup w's 64 queries: five stages, the two
// warpgroups' xa tiles (each takes its own, both release both) and panel p
// of the A_h image.
template <int H>
__device__ __forceinline__ void form_t_tiles(float (&ta)[3][Geo<H>::ACC], int w, const Ring& ring,
                                             int& s) {
  using G = Geo<H>;
  ring.wait(s + 1 - w);
  ring.release(s + 1 - w);
  const unsigned char* Q = ring.wait(s + w);
  const int sq = s + w;
  s += 2;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const unsigned char* ws = ring.wait(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < G::KS; ++k)
      mma_ss<G::PW, 0, 1>(ta[p], kdesc<H, TR>(Q, k), mdesc<H, H>(ws, 0, k), k > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ta[p]);
    ring.release(s++);
  }
  ring.release(sq);
}

template <int H>
__device__ __forceinline__ void push_panels(const Ring& ring, int& s, const unsigned char* wa) {
  using G = Geo<H>;
  for (int p = 0; p < 3; ++p, ++s)
    bulk_load(ring.acquire(s, G::WPANEL_B), wa + p * G::WPANEL_B, G::WPANEL_B,
              &ring.full[s % ring.n]);
}

template <int H>
__device__ __forceinline__ void push_tile(const Ring& ring, int& s, const unsigned char* img,
                                          size_t tile) {
  bulk_load(ring.acquire(s, Geo<H>::TILE_B), img + tile * Geo<H>::TILE_B, Geo<H>::TILE_B,
            &ring.full[s % ring.n]);
  ++s;
}

template <int H>
__global__ void __launch_bounds__(NTH, 1) wide_bwd_query(const BwdArgs a) {
  using G = Geo<H>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const QuerySmem<H> L;
  unsigned char* TB = smem;                   // [2] t tiles (then dt)
  unsigned char* GB = smem + 2 * G::TILE_B;   // [2] g' tiles
  float* RINV = reinterpret_cast<float*>(smem + 4 * G::TILE_B);  // [2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const Ring ring{smem + L.ring_off, bars, bars + L.nstages, L.nstages, G::TILE_B};
  const int tid = threadIdx.x, T = a.T;
  const int ntile = (T + TR - 1) / TR, Tp = ntile * TR;
  const int nqb = (ntile + 1) / 2, items = a.M * nqb;
  const size_t rowsP = size_t(a.M) * Tp, ntiles = size_t(a.M) * ntile;
  if (tid == 0) {
    for (int i = 0; i < L.nstages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NCW / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCW) {  // producer
    regs_producer();
    if (tid == NCW) {
      int s = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int m = item / nqb, qb = item % nqb;
        for (int h = 0; h < a.nh; ++h) {
          for (int w = 0; w < 2; ++w)
            push_tile<H>(ring, s, a.ximg, size_t(m) * ntile + vmin(2 * qb + w, ntile - 1));
          push_panels<H>(ring, s, a.wimg + size_t(2 * h) * G::W_B);
          for (int q = 0; q < ntile; ++q) push_tile<H>(ring, s, a.ximg, size_t(m) * ntile + q);
          const unsigned char* vh = a.vimg + size_t(h) * ntiles * G::TILE_B;
          for (int pass = 0; pass < 2; ++pass)
            for (int q = 0; q < ntile; ++q) {
              push_tile<H>(ring, s, a.ximg, size_t(m) * ntile + q);
              push_tile<H>(ring, s, vh, size_t(m) * ntile + q);
            }
        }
      }
    }
  } else {  // consumers
    regs_consumer();
    const int w = tid >> 7, wt = tid & 127, lane = wt & 31;
    const int g = lane >> 2, t4 = lane & 3, rl = 16 * (wt >> 5) + g;
    unsigned char* Tt = TB + w * G::TILE_B;
    unsigned char* Gt = GB + w * G::TILE_B;
    float* rinv_s = RINV + w * TR;
    int s = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m = item / nqb, qt = 2 * (item % nqb) + w;
      const bool active = qt < ntile;
      const int q0 = qt * TR;
      const size_t tile = size_t(m) * ntile + qt, rowb = size_t(m) * Tp + q0;
      for (int h = 0; h < a.nh; ++h) {
        const float* vh = a.vecs + size_t(h) * G::VEC;
        const size_t hr = size_t(h) * rowsP + rowb;  // this head's stats of row q0
        {
          float ta[3][G::ACC];
          form_t_tiles<H>(ta, w, ring, s);
          if (wt == 0) bulk_store_wait_read();  // the last head's dt has left Tt and g' Gt
          wg_sync(w);
          store_tile<H>(Tt, ta, vh, wt);
        }
        fence_async_smem();
        wg_sync(w);
        if (wt == 0 && active) bulk_store(a.timg + (size_t(h) * ntiles + tile) * G::TILE_B, Tt, G::TILE_B);
        float cq[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = q0 + rl + 8 * hf;
          cq[hf] = active && i < T ? a.tq[hr + rl + 8 * hf] : 0.f;
        }

        // pass 1: the row max and the sum of the unrounded e (online)
        float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        const int s1 = s;
        run_stages<false, Sc1<TR>>(
            ntile,
            [&](int q, Sc1<TR>& sc) {
              const unsigned char* ks = ring.wait(s1 + q);
              wgmma_fence();
              scores_ss<H>(sc.s, Tt, ks);
              wgmma_commit();
            },
            [&](int q, Sc1<TR>& sc) {
              mask_scores<TR>(sc.s, q * TR, T, cq, t4);
              float sm[2] = {-INFINITY, -INFINITY};
#pragma unroll
              for (int e = 0; e < TR / 2; ++e) sm[(e >> 1) & 1] = fmaxf(sm[(e >> 1) & 1], sc.s[e]);
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const float mn = fmaxf(mx[hf], quad_max(sm[hf]));
                l[hf] *= ex2((mx[hf] - mn) * LOG2E);
                mx[hf] = mn;
              }
#pragma unroll
              for (int e = 0; e < TR / 2; ++e)
                l[(e >> 1) & 1] += ex2((sc.s[e] - mx[(e >> 1) & 1]) * LOG2E);
            },
            [&](int, uint32_t(&)[TR / 16][4]) {}, [&](int q) { ring.release(s1 + q); }, nothing);
        s += ntile;
        float rinv[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          rinv[hf] = 1.f / quad_sum(l[hf]);
          if (t4 == 0) rinv_s[rl + 8 * hf] = rinv[hf];
        }
        wg_sync(w);

        // g' = rnd(g / sum(e)) into Gt (16 bytes a thread at a time), and out
        for (int idx = wt; idx < TR * (H / 8); idx += 128) {
          const int r = idx / (H / 8), c0 = (idx % (H / 8)) * 8, i = q0 + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (active && i < T) {
            const uint4 raw = *reinterpret_cast<const uint4*>(a.g + (size_t(m) * T + i) * H + c0);
            const bf16* gv = reinterpret_cast<const bf16*>(&raw);
            const float ri = rinv_s[r];
            v = make_uint4(pack(__bfloat162float(gv[0]) * ri, __bfloat162float(gv[1]) * ri),
                           pack(__bfloat162float(gv[2]) * ri, __bfloat162float(gv[3]) * ri),
                           pack(__bfloat162float(gv[4]) * ri, __bfloat162float(gv[5]) * ri),
                           pack(__bfloat162float(gv[6]) * ri, __bfloat162float(gv[7]) * ri));
          }
          *reinterpret_cast<uint4*>(Gt + img_off<H, TR>(r, c0)) = v;
        }
        fence_async_smem();
        wg_sync(w);
        if (wt == 0 && active) bulk_store(a.gimg + (size_t(h) * ntiles + tile) * G::TILE_B, Gt, G::TILE_B);

        // the unrounded e and dP = g' vo^T of stage q (xa at s0 + 2q, vo at s0 + 2q + 1)
#define NBSS_E_DP(s0)                                               \
  [&](int q, Sc2<TR>& sc) {                                         \
    const unsigned char* ks = ring.wait((s0) + 2 * q);              \
    const unsigned char* vs = ring.wait((s0) + 2 * q + 1);          \
    wgmma_fence();                                                  \
    scores_ss<H>(sc.s, Tt, ks);                                     \
    scores_ss<H>(sc.d, Gt, vs);                                     \
    wgmma_commit();                                                 \
  }
        // pass 2: delta = sum(dP e) / sum(e)
        float dsum[2] = {0.f, 0.f};
        const int s2 = s;
        run_stages<false, Sc2<TR>>(
            ntile, NBSS_E_DP(s2),
            [&](int q, Sc2<TR>& sc) {
              mask_scores<TR>(sc.s, q * TR, T, cq, t4);
#pragma unroll
              for (int k = 0; k < TR / 2; ++k) sc.s[k] = ex2((sc.s[k] - mx[(k >> 1) & 1]) * LOG2E);
#pragma unroll
              for (int k = 0; k < TR / 2; ++k)
                dsum[(k >> 1) & 1] = fmaf(sc.d[k], sc.s[k], dsum[(k >> 1) & 1]);
            },
            [&](int, uint32_t(&)[TR / 16][4]) {},
            [&](int q) {
              ring.release(s2 + 2 * q);
              ring.release(s2 + 2 * q + 1);
            },
            nothing);
        s += 2 * ntile;
        float delta[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) delta[hf] = quad_sum(dsum[hf]) * rinv[hf];

        // pass 3: dS = rnd(e (dP - delta)), dt = dS xa and the row sum of dS
        float dt[3][G::ACC];
        float dsrow[2] = {0.f, 0.f};
        const int s3 = s;
        run_stages<true, Sc2<TR>>(
            ntile, NBSS_E_DP(s3),
            [&](int q, Sc2<TR>& sc) {
              mask_scores<TR>(sc.s, q * TR, T, cq, t4);
#pragma unroll
              for (int k = 0; k < TR / 2; ++k) sc.s[k] = ex2((sc.s[k] - mx[(k >> 1) & 1]) * LOG2E);
#pragma unroll
              for (int k = 0; k < TR / 2; ++k) {
                sc.s[k] = round_bf16(sc.s[k] * (sc.d[k] - delta[(k >> 1) & 1]));
                dsrow[(k >> 1) & 1] += sc.s[k];
              }
            },
            [&](int q, uint32_t (&f)[TR / 16][4]) {
              const unsigned char* xs = ring.slot(s3 + 2 * q);
              wgmma_fence();
#pragma unroll
              for (int p = 0; p < 3; ++p)
#pragma unroll
                for (int ks = 0; ks < TR / 16; ++ks)
                  mma_rs<G::PW, 1>(dt[p], f[ks], mdesc<H, TR>(xs, p, ks), q > 0 || ks > 0);
              wgmma_commit();
            },
            [&](int q) { ring.release(s3 + 2 * q + 1); }, [&](int q) { ring.release(s3 + 2 * q); });
#pragma unroll
        for (int p = 0; p < 3; ++p) fence_regs(dt[p]);
        s += 2 * ntile;
#undef NBSS_E_DP

        // dt out through Tt (its t has left; every warp is done with it), the statistics out
        if (wt == 0) bulk_store_wait_read();
        wg_sync(w);
        store_tile<H>(Tt, dt, nullptr, wt);
        fence_async_smem();
        wg_sync(w);
        if (wt == 0 && active) bulk_store(a.dimg + (size_t(h) * ntiles + tile) * G::TILE_B, Tt, G::TILE_B);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float dh = round_bf16(quad_sum(dsrow[hf]));
          if (active && t4 == 0) {
            const size_t o = hr + rl + 8 * hf;
            a.ms[o] = mx[hf];
            a.dl[o] = delta[hf];
            a.dth[o] = dh;
          }
        }
      }
    }
    if (wt == 0) bulk_store_wait();
  }
}

// A stage of the key kernel: a 64-row tile of t or g', and (t's stages) the
// 64 queries' tq, row max and delta behind it.
template <int H>
__host__ __device__ constexpr int key_stage() { return Geo<H>::TILE_B + 1024; }

template <int H>
struct KeySmem : Smem<H> {
  // each warpgroup's xa and vo key tiles (the vo tile doubles as dvo's staging)
  __host__ __device__ KeySmem() : Smem<H>(4 * Geo<H>::TILE_B, key_stage<H>(), 8) {}
};

// e^T (unrounded, 0 off the edges) of 64 keys by the 64 queries i0 .. i0 + 63
// of a stage: exp(s^T + tq_i - m_i), st = the stage's [tq; m; delta].
__device__ __forceinline__ void exp_t(float (&sc)[TR / 2], int i0, int T, const float* st, int t4) {
#pragma unroll
  for (int j = 0; j < TR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = 8 * j + 2 * t4 + (e & 1);
      sc[4 * j + e] = i0 + il < T ? ex2((sc[4 * j + e] + st[il] - st[TR + il]) * LOG2E) : 0.f;
    }
}

template <int H>
__global__ void __launch_bounds__(NTH, 1) wide_bwd_key(const BwdArgs a) {
  using G = Geo<H>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const KeySmem<H> L;
  unsigned char* QB = smem;                  // [2] xa key tiles
  unsigned char* VB = smem + 2 * G::TILE_B;  // [2] vo key tiles / dvo staging
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* qfull = bars;
  uint64_t* qempty = bars + 2;
  uint64_t* vfull = bars + 4;
  uint64_t* vempty = bars + 6;
  const Ring ring{smem + L.ring_off, bars + 8, bars + 8 + L.nstages, L.nstages, key_stage<H>()};
  const int tid = threadIdx.x, T = a.T;
  const int ntile = (T + TR - 1) / TR, Tp = ntile * TR;
  const int nkb = (ntile + 1) / 2, items = a.M * nkb;
  const size_t rowsP = size_t(a.M) * Tp, ntiles = size_t(a.M) * ntile;
  if (tid == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&qfull[w], 1);
      mbar_init(&qempty[w], 128);
      mbar_init(&vfull[w], 1);
      mbar_init(&vempty[w], 1);
    }
    for (int i = 0; i < L.nstages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NCW / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCW) {  // producer
    regs_producer();
    if (tid == NCW) {
      int s = 0, it = 0, nv = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int m = item / nkb, kb = item % nkb;
        for (int w = 0; w < 2; ++w) {
          if (it > 0) mbar_wait(&qempty[w], (it - 1) & 1);
          mbar_expect_tx(&qfull[w], G::TILE_B);
          bulk_load(QB + w * G::TILE_B,
                    a.ximg + (size_t(m) * ntile + vmin(2 * kb + w, ntile - 1)) * G::TILE_B,
                    G::TILE_B, &qfull[w]);
        }
        for (int pass = 0; pass < 2; ++pass)
          for (int h = 0; h < a.nh; ++h) {
            if (pass == 1) {  // this head's vo key tiles, once the warpgroups are done with VB
              for (int w = 0; w < 2; ++w) {
                mbar_wait(&vempty[w], nv & 1);
                mbar_expect_tx(&vfull[w], G::TILE_B);
                bulk_load(VB + w * G::TILE_B,
                          a.vimg + (size_t(h) * ntiles + size_t(m) * ntile +
                                    vmin(2 * kb + w, ntile - 1)) * G::TILE_B,
                          G::TILE_B, &vfull[w]);
              }
              ++nv;
            }
            const unsigned char* th = a.timg + size_t(h) * ntiles * G::TILE_B;
            const unsigned char* gh = a.gimg + size_t(h) * ntiles * G::TILE_B;
            for (int q = 0; q < ntile; ++q) {
              const size_t tile = size_t(m) * ntile + q, r0 = size_t(h) * rowsP + size_t(m) * Tp + TR * q;
              unsigned char* dst = ring.acquire(s, G::TILE_B + 3 * TR * 4);
              uint64_t* bar = &ring.full[s % ring.n];
              bulk_load(dst, th + tile * G::TILE_B, G::TILE_B, bar);
              bulk_load(dst + G::TILE_B, a.tq + r0, TR * 4, bar);
              bulk_load(dst + G::TILE_B + TR * 4, a.ms + r0, TR * 4, bar);
              bulk_load(dst + G::TILE_B + 2 * TR * 4, a.dl + r0, TR * 4, bar);
              ++s;
              push_tile<H>(ring, s, gh, tile);
            }
          }
      }
    }
  } else {  // consumers
    regs_consumer();
    const int w = tid >> 7, wt = tid & 127, lane = wt & 31;
    const int g = lane >> 2, t4 = lane & 3, rl = 16 * (wt >> 5) + g;
    const unsigned char* Q = QB + w * G::TILE_B;
    unsigned char* V = VB + w * G::TILE_B;
    int s = 0, it = 0, nv = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const int m = item / nkb, kt = 2 * (item % nkb) + w;
      const bool active = kt < ntile;
      const int k0 = kt * TR;
      const size_t tile = size_t(m) * ntile + kt;
      mbar_wait(&qfull[w], it & 1);

      // pass A: dvo = rnd(rnd(e)^T g') per head, out through V (t at sa + 2q, g' at sa + 2q + 1)
      for (int h = 0; h < a.nh; ++h) {
        float dvo[3][G::ACC];
        const int sa = s;
        run_stages<true, Sc1<TR>>(
            ntile,
            [&](int q, Sc1<TR>& sc) {
              const unsigned char* ts = ring.wait(sa + 2 * q);
              wgmma_fence();
              scores_ss<H>(sc.s, Q, ts);
              wgmma_commit();
            },
            [&](int q, Sc1<TR>& sc) {
              exp_t(sc.s, q * TR, T, reinterpret_cast<const float*>(ring.slot(sa + 2 * q) + G::TILE_B), t4);
              ring.release(sa + 2 * q);
#pragma unroll
              for (int k = 0; k < TR / 2; ++k) sc.s[k] = round_bf16(sc.s[k]);
            },
            [&](int q, uint32_t (&f)[TR / 16][4]) {
              const unsigned char* gs = ring.wait(sa + 2 * q + 1);
              wgmma_fence();
#pragma unroll
              for (int p = 0; p < 3; ++p)
#pragma unroll
                for (int ks = 0; ks < TR / 16; ++ks)
                  mma_rs<G::PW, 1>(dvo[p], f[ks], mdesc<H, TR>(gs, p, ks), q > 0 || ks > 0);
              wgmma_commit();
            },
            nothing, [&](int q) { ring.release(sa + 2 * q + 1); });
#pragma unroll
        for (int p = 0; p < 3; ++p) fence_regs(dvo[p]);
        s += 2 * ntile;
        if (wt == 0) bulk_store_wait_read();
        wg_sync(w);
        store_tile<H>(V, dvo, nullptr, wt);
        fence_async_smem();
        wg_sync(w);
        if (wt == 0 && active) bulk_store(a.oimg + (size_t(h) * ntiles + tile) * G::TILE_B, V, G::TILE_B);
      }
      if (wt == 0) {
        bulk_store_wait_read();
        mbar_arrive(&vempty[w]);
      }

      // pass B: dS^T = rnd(e^T (vo g'^T - delta)), dxa = sum_h dS^T t
      float dxa[3][G::ACC];
      for (int h = 0; h < a.nh; ++h) {
        mbar_wait(&vfull[w], nv & 1);
        ++nv;
        const int sb = s;
        run_stages<true, Sc2<TR>>(
            ntile,
            [&](int q, Sc2<TR>& sc) {
              const unsigned char* ts = ring.wait(sb + 2 * q);
              const unsigned char* gs = ring.wait(sb + 2 * q + 1);
              wgmma_fence();
              scores_ss<H>(sc.s, Q, ts);
              scores_ss<H>(sc.d, V, gs);
              wgmma_commit();
            },
            [&](int q, Sc2<TR>& sc) {
              const float* st = reinterpret_cast<const float*>(ring.slot(sb + 2 * q) + G::TILE_B);
              exp_t(sc.s, q * TR, T, st, t4);
#pragma unroll
              for (int j = 0; j < TR / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int k = 4 * j + e;
                  sc.s[k] = round_bf16(sc.s[k] * (sc.d[k] - st[2 * TR + 8 * j + 2 * t4 + (e & 1)]));
                }
            },
            [&](int q, uint32_t (&f)[TR / 16][4]) {
              const unsigned char* ts = ring.slot(sb + 2 * q);
              wgmma_fence();
#pragma unroll
              for (int p = 0; p < 3; ++p)
#pragma unroll
                for (int ks = 0; ks < TR / 16; ++ks)
                  mma_rs<G::PW, 1>(dxa[p], f[ks], mdesc<H, TR>(ts, p, ks), h > 0 || q > 0 || ks > 0);
              wgmma_commit();
            },
            [&](int q) { ring.release(sb + 2 * q + 1); }, [&](int q) { ring.release(sb + 2 * q); });
#pragma unroll
        for (int p = 0; p < 3; ++p) fence_regs(dxa[p]);
        s += 2 * ntile;
        if (h < a.nh - 1) {
          wg_sync(w);  // every warp is done with V
          if (wt == 0) mbar_arrive(&vempty[w]);
        }
      }
      mbar_arrive(&qempty[w]);
      if (active) {
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < G::ACC / 4; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int jr = k0 + rl + 8 * hf, col = p * G::PW + 8 * j + 2 * t4;
              if (jr < T)
                *reinterpret_cast<float2*>(a.dxa + (size_t(m) * T + jr) * H + col) =
                    make_float2(dxa[p][4 * j + 2 * hf], dxa[p][4 * j + 2 * hf + 1]);
            }
      }
    }
    if (wt == 0) bulk_store_wait();
  }
}

// dxa += sum_h (dt_h A_h^T + dvo_h Wvo_h^T) + dt_h[:, H] acol_h for each
// warpgroup's 64-row tile: one product over the 2 nh H channels, streamed a
// panel at a time (the weight panel and each warpgroup's operand panel).
template <int H>
__global__ void __launch_bounds__(NTH, 1) wide_bwd_dxa(const BwdArgs a) {
  using G = Geo<H>;
  constexpr int STAGE = G::WPANEL_B + 2 * TR * G::PB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const Smem<H> L(0, STAGE, 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const Ring ring{smem + L.ring_off, bars, bars + L.nstages, L.nstages, STAGE};
  const int tid = threadIdx.x, T = a.T;
  const int ntile = (T + TR - 1) / TR, Tp = ntile * TR;
  const size_t rowsP = size_t(a.M) * Tp, ntiles = size_t(a.M) * ntile;
  const int items = int((ntiles + 1) / 2);
  if (tid == 0) {
    for (int i = 0; i < L.nstages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NCW / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NCW) {  // producer
    regs_producer();
    if (tid == NCW) {
      int s = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x)
        for (int h = 0; h < a.nh; ++h)
          for (int op = 0; op < 2; ++op)
            for (int kp = 0; kp < 3; ++kp, ++s) {
              unsigned char* dst = ring.acquire(s, STAGE);
              uint64_t* bar = &ring.full[s % ring.n];
              bulk_load(dst, a.wimg + size_t(2 * h + op) * G::W_B + kp * G::WPANEL_B, G::WPANEL_B, bar);
              const unsigned char* img = (op ? a.oimg : a.dimg) + size_t(h) * ntiles * G::TILE_B;
              for (int w = 0; w < 2; ++w)
                bulk_load(dst + G::WPANEL_B + w * TR * G::PB,
                          img + vmin<size_t>(2 * size_t(item) + w, ntiles - 1) * G::TILE_B +
                              kp * TR * G::PB,
                          TR * G::PB, bar);
            }
    }
  } else {  // consumers
    regs_consumer();
    const int w = tid >> 7, wt = tid & 127, lane = wt & 31;
    const int g = lane >> 2, t4 = lane & 3, rl = 16 * (wt >> 5) + g;
    int s = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const size_t tile = 2 * size_t(item) + w;
      float acc[3][G::ACC];
      for (int h = 0; h < a.nh; ++h)
        for (int op = 0; op < 2; ++op)
          for (int kp = 0; kp < 3; ++kp, ++s) {
            const unsigned char* st = ring.wait(s);
            const unsigned char* ap = st + G::WPANEL_B + w * TR * G::PB;
            wgmma_fence();
#pragma unroll
            for (int n = 0; n < 3; ++n)
#pragma unroll
              for (int k = 0; k < G::KSP; ++k)
                mma_ss<G::PW, 0, 0>(acc[n], desc_plus(desc<G::PB>(ap, 16), 32 * k),
                                    desc_plus(desc<G::PB>(st, 16), n * G::PW * G::PB + 32 * k),
                                    h > 0 || op > 0 || kp > 0 || k > 0);
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int n = 0; n < 3; ++n) fence_regs(acc[n]);
            ring.release(s);
          }
      if (tile >= ntiles) continue;
      const int m = int(tile / ntile), k0 = int(tile % ntile) * TR;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int jr = k0 + rl + 8 * hf;
        if (jr >= T) continue;
        for (int h = 0; h < a.nh; ++h) {  // + dt_h[:, H] acol_h, in head order
          const float d = a.dth[size_t(h) * rowsP + size_t(m) * Tp + jr];
          const float* acol = a.vecs + size_t(h) * G::VEC + 2 * H;
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int j = 0; j < G::ACC / 4; ++j) {
              const int col = p * G::PW + 8 * j + 2 * t4;
              acc[p][4 * j + 2 * hf] = fmaf(d, acol[col], acc[p][4 * j + 2 * hf]);
              acc[p][4 * j + 2 * hf + 1] = fmaf(d, acol[col + 1], acc[p][4 * j + 2 * hf + 1]);
            }
        }
        float* out = a.dxa + (size_t(m) * T + jr) * H;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < G::ACC / 4; ++j) {
            const int col = p * G::PW + 8 * j + 2 * t4;
            float2* o = reinterpret_cast<float2*>(out + col);
            const float2 k = *o;
            *o = make_float2(acc[p][4 * j + 2 * hf] + k.x, acc[p][4 * j + 2 * hf + 1] + k.y);
          }
      }
    }
  }
}

// LayerNorm adjoint, a warp per row: dx = g + rsig (dxhat - mean(dxhat) -
// xhat mean(dxhat xhat)), dxhat = dxa ln[0]; the block's sums of dxa xhat,
// dxa and g (dln, dc) over its rows, its warps added in a fixed order.
template <int H>
__global__ void __launch_bounds__(256) wide_ln_bwd(const bf16* __restrict__ x,
                                                   const bf16* __restrict__ g,
                                                   const float* __restrict__ ln,
                                                   const float* __restrict__ dxa,
                                                   bf16* __restrict__ dx, float* __restrict__ part,
                                                   int rows, float eps) {
  constexpr int C = H / 32, NW = 8;
  __shared__ float red[NW][3 * H];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a0[C] = {}, a1[C] = {}, a2[C] = {};
  for (int j = blockIdx.x * NW + warp; j < rows; j += gridDim.x * NW) {
    float v[C], gv[C], dl[C], s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = size_t(j) * H + lane + 32 * c;
      v[c] = __bfloat162float(x[o]);
      gv[c] = __bfloat162float(g[o]);
      dl[c] = dxa[o];
      s += v[c];
    }
    const float mu = warp_sum(s) / float(H);
    float d2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] -= mu;
      d2 = fmaf(v[c], v[c], d2);
    }
    const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
    float xh[C], dxh[C], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane + 32 * c;
      xh[c] = v[c] * rs;
      dxh[c] = dl[c] * ln[k];
      s1 += dxh[c];
      s2 = fmaf(dxh[c], xh[c], s2);
      a0[c] = fmaf(dl[c], xh[c], a0[c]);
      a1[c] += dl[c];
      a2[c] += gv[c];
    }
    const float m1 = warp_sum(s1) / float(H), m2 = warp_sum(s2) / float(H);
#pragma unroll
    for (int c = 0; c < C; ++c)
      dx[size_t(j) * H + lane + 32 * c] = __float2bfloat16(gv[c] + rs * (dxh[c] - m1 - xh[c] * m2));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    red[warp][lane + 32 * c] = a0[c];
    red[warp][H + lane + 32 * c] = a1[c];
    red[warp][2 * H + lane + 32 * c] = a2[c];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 3 * H; k += 256) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w][k];
    part[size_t(blockIdx.x) * 3 * H + k] = s;
  }
}

// Warpgroups of the weight products: one per 64 rows of xa^T (H = 192: three
// panels; H = 96: rows 0-63 and 32-95, the second keeping 64-95).
template <int H>
__host__ __device__ constexpr int weight_groups() { return H == 192 ? 3 : 2; }

// part[slice][y][i][c] = sum over the slice's tiles of xa[:, i] D[:, c] (i, c
// < H), y = 2h (D = dt_h) or 2h + 1 (D = dvo_h): xa read transposed.
template <int H>
__global__ void __launch_bounds__(weight_groups<H>() * 128 + 32, 1)
    wide_bwd_weights(const BwdArgs a, float* __restrict__ part, int per) {
  using G = Geo<H>;
  constexpr int NWG = weight_groups<H>(), NC = NWG * 128, STAGE = 2 * G::TILE_B;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const Smem<H> L(0, STAGE, 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const Ring ring{smem + L.ring_off, bars, bars + L.nstages, L.nstages, STAGE};
  const int tid = threadIdx.x, y = blockIdx.y, h = y / 2;
  const int ntile = (a.T + TR - 1) / TR;
  const size_t ntiles = size_t(a.M) * ntile;
  const size_t t0 = size_t(blockIdx.x) * per, t1 = vmin(ntiles, t0 + per);
  const unsigned char* D = ((y & 1) ? a.oimg : a.dimg) + size_t(h) * ntiles * G::TILE_B;
  if (tid == 0) {
    for (int i = 0; i < L.nstages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NC / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= NC) {  // producer
    if (tid != NC) return;
    int s = 0;
    for (size_t t = t0; t < t1; ++t, ++s) {
      unsigned char* dst = ring.acquire(s, STAGE);
      bulk_load(dst, a.ximg + t * G::TILE_B, G::TILE_B, &ring.full[s % ring.n]);
      bulk_load(dst + G::TILE_B, D + t * G::TILE_B, G::TILE_B, &ring.full[s % ring.n]);
    }
    return;
  }
  const int w = tid >> 7, wt = tid & 127, lane = wt & 31;
  const int g = lane >> 2, t4 = lane & 3, rl = 16 * (wt >> 5) + g;
  const int i0 = H == 192 ? 64 * w : 32 * w;  // first row of xa^T this warpgroup computes
  float acc[3][G::ACC];
  int s = 0;
  for (size_t t = t0; t < t1; ++t, ++s) {
    const unsigned char* st = ring.wait(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TR / 16; ++ks)
#pragma unroll
      for (int n = 0; n < 3; ++n)
        mma_ss<G::PW, 1, 1>(acc[n], mdesc<H, TR>(st, i0 / G::PW, ks),
                            mdesc<H, TR>(st + G::TILE_B, n, ks), t > t0 || ks > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < 3; ++n) fence_regs(acc[n]);
    ring.release(s);
  }
  float* out = part + (size_t(blockIdx.x) * gridDim.y + y) * H * H;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = rl + 8 * hf;
    if (H == 96 && w == 1 && r < 32) continue;
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int j = 0; j < G::ACC / 4; ++j) {
        const int col = n * G::PW + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(out + size_t(i0 + r) * H + col) =
            make_float2(acc[n][4 * j + 2 * hf], acc[n][4 * j + 2 * hf + 1]);
      }
  }
}

// The ones lane's sums over each slice: ext[slice][y] = [sum_r D[r][c] (c <
// H), sum_r xa[r][i] dt[r][H] (i < H, y even), sum_r dt[r][H] (y even)] over
// the rows r < T of the slice's tiles; warp w takes rows w, w + 8, ..., lane
// l channels 8 l .. 8 l + 7 (16 bytes of a row), and the eight warps' sums
// are added in order.
template <int H>
__global__ void __launch_bounds__(256) wide_bwd_extras(const BwdArgs a, float* __restrict__ ext, int per) {
  using G = Geo<H>;
  __shared__ float red[8][2 * H + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, y = blockIdx.y, h = y / 2;
  const int T = a.T, ntile = (T + TR - 1) / TR, Tp = ntile * TR;
  const size_t ntiles = size_t(a.M) * ntile, rowsP = size_t(a.M) * Tp;
  const size_t t0 = size_t(blockIdx.x) * per, t1 = vmin(ntiles, t0 + per);
  const bool dt = (y & 1) == 0, live = lane < H / 8;
  const int c0 = 8 * lane;
  const unsigned char* D = (dt ? a.dimg : a.oimg) + size_t(h) * ntiles * G::TILE_B;
  float cs[8] = {}, xs[8] = {}, ts = 0.f;
  for (size_t t = t0; t < t1; ++t) {
    const int m = int(t / ntile), j0 = int(t % ntile) * TR;
    const int n = vmin(TR, T - j0);
    const float* dth = a.dth + size_t(h) * rowsP + size_t(m) * Tp + j0;
    for (int r = warp; r < n; r += 8) {
      const float d = dt ? dth[r] : 0.f;
      ts += d;
      if (!live) continue;
      const uint32_t o = img_off<H, TR>(r, c0);
      const uint4 dv = *reinterpret_cast<const uint4*>(D + t * G::TILE_B + o);
      const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int k = 0; k < 8; ++k) cs[k] += __bfloat162float(dp[k]);
      if (dt) {
        const uint4 xv = *reinterpret_cast<const uint4*>(a.ximg + t * G::TILE_B + o);
        const bf16* xp = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
        for (int k = 0; k < 8; ++k) xs[k] = fmaf(__bfloat162float(xp[k]), d, xs[k]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[warp][c0 + k] = cs[k];
      red[warp][H + c0 + k] = xs[k];
    }
  }
  if (lane == 0) red[warp][2 * H] = ts;
  __syncthreads();
  float* out = ext + (size_t(blockIdx.x) * gridDim.y + y) * (2 * H + 1);
  for (int k = threadIdx.x; k < 2 * H + 1; k += 256) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[w][k];
    out[k] = v;
  }
}

// out = [dA: nh HA HA][dWvo: nh HA HA][dln: 2H][dc: H], each the sum over
// slices (weight partials, nslices; ext, nx) or blocks (part [nblocks][3H])
// in order.
template <int H>
__global__ void wide_bwd_reduce(const float* __restrict__ wpart, const float* __restrict__ ext,
                                const float* __restrict__ part, float* __restrict__ out,
                                int nslices, int nx, int nblocks, int nh) {
  constexpr int HA = H + 2;
  const size_t n_w = 2 * size_t(nh) * HA * HA, n = n_w + 3 * H;
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (e < n_w) {
      const size_t per = size_t(nh) * HA * HA;
      const int which = int(e / per);
      const size_t r = e % per;
      const int h = int(r / (HA * HA)), i = int(r % (HA * HA)) / HA, k = int(r % HA);
      const size_t y = 2 * h + which;
      if (i < H && k < H) {
        for (int sl = 0; sl < nslices; ++sl)
          s += wpart[(size_t(sl) * 2 * nh + y) * H * H + size_t(i) * H + k];
      } else {
        const int at = i == H && k < H ? k : which == 0 && i < H && k == H ? H + i
                       : which == 0 && i == H && k == H ? 2 * H : -1;
        if (at >= 0)
          for (int sl = 0; sl < nx; ++sl) s += ext[(size_t(sl) * 2 * nh + y) * (2 * H + 1) + at];
      }
    } else {
      for (int b = 0; b < nblocks; ++b) s += part[size_t(b) * 3 * H + (e - n_w)];
    }
    out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int H>
struct Shape {
  int ntile, Tp;
  size_t ntiles, rowsP;
  Shape(int M, int T) : ntile((T + TR - 1) / TR), Tp(ntile * TR),
                        ntiles(size_t(M) * ntile), rowsP(size_t(M) * Tp) {}
};

// The forward's workspace, in bytes, in order.
template <int H>
struct FwdLayout {
  size_t wimg, vecs, ximg, vimg, tq, total;
  FwdLayout(int chunk, int T, int nh) {
    using G = Geo<H>;
    const Shape<H> S(chunk, T);
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align1k(bytes); return at; };
    wimg = take(size_t(2 * nh) * G::W_B);
    vecs = take(size_t(nh) * G::VEC * 4);
    ximg = take(S.ntiles * G::TILE_B);
    vimg = take(size_t(nh) * S.ntiles * G::TILE_B);
    tq = take(size_t(nh) * S.rowsP * 4);
    total = off;
  }
};

template <typename K>
cudaError_t smem_attr(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The key and vo images of a chunk: prep (once), LN, vo.
template <int H>
cudaError_t keys_and_vo(const bf16* x, const float* ln, unsigned char* wimg, float* vecs,
                        unsigned char* ximg, unsigned char* vimg, float* tq, int mc, int T, int nh,
                        int nblocks, float eps, cudaStream_t s) {
  using G = Geo<H>;
  const Shape<H> S(mc, T);
  wide_ln<H><<<int((S.rowsP * (H / 24) + 255) / 256), 256, 0, s>>>(x, ln, vecs, ximg, tq, mc, T, nh, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Smem<H> V(G::W_B + 2 * G::TILE_B, G::TILE_B, 1);
  if ((err = smem_attr(wide_vo<H>, V.total)) != cudaSuccess) return err;
  const int bx = int(std::max<size_t>(1, std::min<size_t>(S.ntiles, (nblocks + nh - 1) / nh)));
  wide_vo<H><<<dim3(bx, nh), NVO, V.total, s>>>(ximg, wimg, vecs, vimg, int(S.ntiles));
  return cudaGetLastError();
}

template <int H>
int forward(const void* x, const void* ln, const void* A, const void* Wvo, const void* c, void* y,
            void* ws, int M, int T, int nh, int chunk, int nblocks, float eps, cudaStream_t s) {
  const FwdLayout<H> L(chunk, T, nh);
  unsigned char* base = static_cast<unsigned char*>(ws);
  unsigned char* wimg = base + L.wimg;
  float* vecs = reinterpret_cast<float*>(base + L.vecs);
  wide_prep<H><<<nh, 256, 0, s>>>(static_cast<const float*>(A), static_cast<const float*>(Wvo),
                                  wimg, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const AttnSmem<H> AS;
  if ((err = smem_attr(wide_attn<H>, AS.total)) != cudaSuccess) return int(err);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  const int ntile = (T + TR - 1) / TR, nqb = (ntile + 1) / 2;
  for (int m0 = 0; m0 < M; m0 += chunk) {
    const int mc = std::min(chunk, M - m0);
    const bf16* xc = xb + size_t(m0) * T * H;
    float* tq = reinterpret_cast<float*>(base + L.tq);
    if ((err = keys_and_vo<H>(xc, static_cast<const float*>(ln), wimg, vecs, base + L.ximg,
                              base + L.vimg, tq, mc, T, nh, nblocks, eps, s)) != cudaSuccess)
      return int(err);
    const AttnArgs aa{base + L.ximg, base + L.vimg, wimg, vecs, tq, xc,
                      static_cast<const float*>(c), yb + size_t(m0) * T * H, mc, T, nh};
    wide_attn<H><<<std::min(mc * nqb, nblocks), NTH, AS.total, s>>>(aa);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}

// Slices of the ones lane's sums: EXTRAS_TILES tiles a block.
constexpr int EXTRAS_TILES = 8;
inline size_t extras_slices(size_t ntiles) { return (ntiles + EXTRAS_TILES - 1) / EXTRAS_TILES; }

// Slices of the weight products: ceil(tiles / nslices) tiles each, every slice non-empty.
inline int slice_tiles(size_t ntiles, int nslices) {
  return int((ntiles + nslices - 1) / nslices);
}

// The backward's workspace, in bytes, in order.
template <int H>
struct BwdLayout {
  size_t wimg, vecs, ximg, vimg, timg, gimg, dimg, oimg, tq, ms, dl, dth, dxa, part, wpart, ext,
      total;
  BwdLayout(int M, int T, int nh, int nblocks, int nslices) {
    using G = Geo<H>;
    const Shape<H> S(M, T);
    size_t off = 0;
    auto take = [&](size_t bytes) { const size_t at = off; off += align1k(bytes); return at; };
    const size_t img = size_t(nh) * S.ntiles * G::TILE_B, stat = size_t(nh) * S.rowsP * 4;
    wimg = take(size_t(2 * nh) * G::W_B);
    vecs = take(size_t(nh) * G::VEC * 4);
    ximg = take(S.ntiles * G::TILE_B);
    vimg = take(img);
    timg = take(img);
    gimg = take(img);
    dimg = take(img);
    oimg = take(img);
    tq = take(stat);
    ms = take(stat);
    dl = take(stat);
    dth = take(stat);
    dxa = take(size_t(M) * T * H * 4);
    part = take(size_t(nblocks) * 3 * H * 4);
    wpart = take(size_t(nslices) * 2 * nh * H * H * 4);
    ext = take(extras_slices(S.ntiles) * 2 * nh * (2 * H + 1) * 4);
    total = off;
  }
};

template <int H>
int backward(const void* x, const void* ln, const void* A, const void* Wvo, const void* g,
             void* dx, void* out, void* ws, int nblocks, int nslices, int M, int T, int nh,
             float eps, cudaStream_t s) {
  using G = Geo<H>;
  const BwdLayout<H> L(M, T, nh, nblocks, nslices);
  const Shape<H> S(M, T);
  unsigned char* base = static_cast<unsigned char*>(ws);
  auto f32 = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  const BwdArgs b{base + L.ximg, base + L.vimg, base + L.wimg, f32(L.vecs), f32(L.tq),
                  static_cast<const bf16*>(g), base + L.timg, base + L.gimg, base + L.dimg,
                  base + L.oimg, f32(L.ms), f32(L.dl), f32(L.dth), f32(L.dxa), M, T, nh};
  wide_prep<H><<<nh, 256, 0, s>>>(static_cast<const float*>(A), static_cast<const float*>(Wvo),
                                  base + L.wimg, f32(L.vecs));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if ((err = keys_and_vo<H>(static_cast<const bf16*>(x), static_cast<const float*>(ln),
                            base + L.wimg, f32(L.vecs), base + L.ximg, base + L.vimg, f32(L.tq),
                            M, T, nh, nblocks, eps, s)) != cudaSuccess)
    return int(err);
  const QuerySmem<H> QS;
  const KeySmem<H> KS;
  const Smem<H> DS(0, G::WPANEL_B + 2 * TR * G::PB, 0);
  const Smem<H> WS(0, 2 * G::TILE_B, 0);
  if ((err = smem_attr(wide_bwd_query<H>, QS.total)) != cudaSuccess ||
      (err = smem_attr(wide_bwd_key<H>, KS.total)) != cudaSuccess ||
      (err = smem_attr(wide_bwd_dxa<H>, DS.total)) != cudaSuccess ||
      (err = smem_attr(wide_bwd_weights<H>, WS.total)) != cudaSuccess)
    return int(err);
  const int items = M * ((S.ntile + 1) / 2);
  const int grid = std::min(items, nblocks);
  wide_bwd_query<H><<<grid, NTH, QS.total, s>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wide_bwd_key<H><<<grid, NTH, KS.total, s>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  wide_bwd_dxa<H><<<int(std::min<size_t>((S.ntiles + 1) / 2, nblocks)), NTH, DS.total, s>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  float* part = f32(L.part);
  wide_ln_bwd<H><<<nblocks, 256, 0, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                                         static_cast<const float*>(ln), f32(L.dxa),
                                         static_cast<bf16*>(dx), part, M * T, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int per = slice_tiles(S.ntiles, nslices);
  const int ns = int((S.ntiles + per - 1) / per);
  wide_bwd_weights<H><<<dim3(ns, 2 * nh), weight_groups<H>() * 128 + 32, WS.total, s>>>(
      b, f32(L.wpart), per);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int nx = int(extras_slices(S.ntiles));
  wide_bwd_extras<H><<<dim3(nx, 2 * nh), 256, 0, s>>>(b, f32(L.ext), EXTRAS_TILES);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const int n = int(2 * nh * (H + 2) * (H + 2) + 3 * H);
  wide_bwd_reduce<H><<<(n + 255) / 256, 256, 0, s>>>(f32(L.wpart), f32(L.ext), part,
                                                      static_cast<float*>(out), ns, nx, nblocks, nh);
  return int(cudaGetLastError());
}

bool takes(int M, int T, int H, int nh) {
  return M >= 1 && T >= 1 && (H == 96 || H == 192) && nh >= 1 && H % nh == 0;
}

}  // namespace

// Bytes of workspace the forward needs for chunks of `chunk` sequences of T
// frames, H channels and nh heads (nblocks: kept for the interface).
extern "C" long long nbss_attention_block_wide_tc_workspace_bytes(int chunk, int T, int H, int nh,
                                                                 int nblocks) {
  (void)nblocks;
  if (H == 96) return static_cast<long long>(FwdLayout<96>(chunk, T, nh).total);
  if (H == 192) return static_cast<long long>(FwdLayout<192>(chunk, T, nh).total);
  return -1;
}

// y = the folded attention block of x, bf16, on `stream`. x, y [M, T, H]
// bfloat16; ln [2, H], A and Wvo [nh, H+2, H+2], c [H] float32; all
// contiguous. ws: the workspace's bytes for (chunk, T, H, nh, nblocks),
// 256-byte aligned, any content. Sequences go through it `chunk` at a time;
// nblocks persistent attention blocks. Returns the CUDA error of the launches
// (0 on success); shapes it is not built for return cudaErrorInvalidValue
// without launching.
extern "C" int nbss_attention_block_wide_tc_fwd(const void* x, const void* ln, const void* A,
                                                const void* Wvo, const void* c, void* y, void* ws,
                                                int M, int T, int H, int nh, int chunk,
                                                int nblocks, float eps, void* stream) {
  if (!takes(M, T, H, nh) || chunk < 1 || nblocks < 1 ||
      (long long)chunk * T * (H + 16) > 2147483647LL ||
      (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 96) return forward<96>(x, ln, A, Wvo, c, y, ws, M, T, nh, chunk, nblocks, eps, s);
  return forward<192>(x, ln, A, Wvo, c, y, ws, M, T, nh, chunk, nblocks, eps, s);
}

// Bytes of workspace the backward needs (every sequence at once), nblocks
// persistent blocks and at most nslices row slices of the weight products.
extern "C" long long nbss_attention_block_wide_bwd_tc_workspace_bytes(int M, int T, int H, int nh,
                                                                     int nblocks, int nslices) {
  if (H == 96) return static_cast<long long>(BwdLayout<96>(M, T, nh, nblocks, nslices).total);
  if (H == 192) return static_cast<long long>(BwdLayout<192>(M, T, nh, nblocks, nslices).total);
  return -1;
}

// The adjoint, bf16: x, g, dx [M, T, H] bfloat16; ln, A, Wvo float32 as the
// forward's; out float32 [2 nh (H+2)^2 + 3H] = dA, dWvo, dln, dc one after
// another. ws: the workspace's bytes, 256-byte aligned, any content. Returns
// the CUDA error of the launches (0 on success).
extern "C" int nbss_attention_block_wide_bwd_tc(const void* x, const void* ln, const void* A,
                                                const void* Wvo, const void* g, void* dx,
                                                void* out, void* ws, int nblocks, int nslices,
                                                int M, int T, int H, int nh, float eps,
                                                void* stream) {
  if (!takes(M, T, H, nh) || nblocks < 1 || nslices < 1 ||
      (long long)M * T * (H + 16) > 2147483647LL || (reinterpret_cast<uintptr_t>(ws) & 255) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 96) return backward<96>(x, ln, A, Wvo, g, dx, out, ws, nblocks, nslices, M, T, nh, eps, s);
  return backward<192>(x, ln, A, Wvo, g, dx, out, ws, nblocks, nslices, M, T, nh, eps, s);
}
