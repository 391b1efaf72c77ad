// Narrow-band attention block, forward, for Hopper (sm_90a), float32: fp32
// FMA on the CUDA cores, since no tensor-core product keeps float32's
// digits. bf16 inputs take attention_block_tc.cu (bf16 tensor cores).
//
// Computes, for each of M independent sequences x[m] of T frames by H = 96
// channels,
//
//     y = x + sum_h softmax(xa A_h xa^T) (xa Wvo_h)[:, :H] + c,
//     xa = [LayerNorm(x), 1]
//
// with the folded operands that fold_weights() builds (A_h = Wq_h Wk_h^T /
// sqrt(dh) plus the bias row, Wvo_h = Wv_h Wo_h plus the ones lane). The
// operands are [nh, H+2, H+2]; lane H+1 (the TPU kernel's pad lane) is zero
// for every real frame, so the ragged key edge is masked here by index and
// lane H+1 is never read.
//
// Replaces the Pallas TPU kernel _fused_block / _kernel in
// nbss_tpu/ops/attention_block.py.
//
// What bounds it on an H100: arithmetic. At the flagship shape (M = 2064,
// T = 251, nh = 4) one call moves about 199 MB in bf16 (59 us at 3.35 TB/s)
// but the folded function does about 283 GFLOP, which this first version
// runs as fp32 FMA on the CUDA cores. The design answers the memory side
// completely: one block per (sequence, 64-query tile) holds LayerNorm(x) of
// the whole sequence (256 x 100 floats) and a 64 x 256 score tile in shared
// memory, so no [T, T] matrix and no q/k/v ever reach device memory; the
// four heads are summed in registers and y is written once. The arithmetic
// side is left to a later change (mma.sync / wgmma on bf16 operands).
//
// Order of the work per head h, for the block's 64 query rows:
//   t  = xa_q A_h            (rounded to the input type, as the reference)
//   s  = t xa^T              (fp32; keys >= T set to -inf)
//   p  = softmax(s)          (fp32 statistics, rounded to the input type)
//   u  = p xa                (fp32)
//   o += u Wvo_h             (fp32, kept in registers across heads)
// Computing u = p xa and then u Wvo_h, instead of p (xa Wvo_h), is the same
// product associated the other way: it makes the work proportional to the
// query tile, so no block computes values for keys it does not own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 96;         // channels the kernel is built for
constexpr int HA = H + 2;     // row stride of the folded operands
constexpr int TMAX = 256;     // longest sequence whose frames fit in shared memory
constexpr int QT = 64;        // query rows per block
constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int RW = QT / NW;   // query rows owned by one warp
constexpr int LDX = H + 4;    // padded row stride (floats): 16-byte rows, no bank conflicts

constexpr size_t SMEM_FLOATS = size_t(TMAX) * LDX   // xs: LayerNorm rows of the sequence
                             + size_t(QT) * LDX     // tu: t, later u
                             + size_t(QT) * TMAX    // ps: scores, later probabilities
                             + 2 * QT;              // tc, psum
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
static_assert(H == 3 * 32, "each lane owns three channels");

template <typename E> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename E>
__global__ void __launch_bounds__(NT, 1)
attention_block_kernel(const E* __restrict__ x, const float* __restrict__ ln,
                       const float* __restrict__ A, const float* __restrict__ Wvo,
                       const float* __restrict__ cvec, E* __restrict__ y,
                       int T, int nh, float eps) {
  using D = Elem<E>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [TMAX][LDX]
  float* tu = xs + TMAX * LDX;    // [QT][LDX]
  float* ps = tu + QT * LDX;      // [QT][TMAX]
  float* tc = ps + QT * TMAX;     // [QT]  lane H of t: a constant per query row
  float* psum = tc + QT;          // [QT]  sum of the rounded p of a row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * QT;
  const E* xm = x + size_t(blockIdx.x) * T * H;
  E* ym = y + size_t(blockIdx.x) * T * H;

  // LayerNorm of every frame, rounded to the input type; frames >= T are zero
  for (int j = warp; j < TMAX; j += NW) {
    float* row = xs + j * LDX;
    if (j < T) {
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = D::load(xm + j * H + lane + 32 * c);
      const float mu = warp_sum(v[0] + v[1] + v[2]) / float(H);
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] -= mu;
        d2 = fmaf(v[c], v[c], d2);
      }
      const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = lane + 32 * c;
        row[k] = D::round(v[c] * rs * ln[k] + ln[H + k]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) row[lane + 32 * c] = 0.f;
    }
  }
  __syncthreads();

  float out[RW][3];  // rows warp*RW + i, channels lane + 32c, summed over heads
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[i][c] = 0.f;

  for (int h = 0; h < nh; ++h) {
    const float* Ah = A + size_t(h) * HA * HA;
    const float* Wh = Wvo + size_t(h) * HA * HA;

    // t = xa_q A_h for this warp's rows (the ones lane contributes row H)
    {
      float acc[RW][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float b = D::round(__ldg(Ah + H * HA + lane + 32 * c));
#pragma unroll
        for (int i = 0; i < RW; ++i) acc[i][c] = b;
      }
      for (int k = 0; k < H; k += 4) {
        float a[4][3];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < 3; ++c) a[kk][c] = D::round(__ldg(Ah + (k + kk) * HA + lane + 32 * c));
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + (q0 + warp * RW + i) * LDX + k);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = acc[i][c];
            s = fmaf(xv.x, a[0][c], s);
            s = fmaf(xv.y, a[1][c], s);
            s = fmaf(xv.z, a[2][c], s);
            acc[i][c] = fmaf(xv.w, a[3][c], s);
          }
        }
      }
      float acol[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) acol[c] = D::round(__ldg(Ah + (lane + 32 * c) * HA + H));
      const float a_hh = D::round(__ldg(Ah + H * HA + H));
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int r = warp * RW + i;
        const float* xr = xs + (q0 + r) * LDX;
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) p = fmaf(xr[lane + 32 * c], acol[c], p);
        p = warp_sum(p) + a_hh;
        if (lane == 0) tc[r] = D::round(p);
#pragma unroll
        for (int c = 0; c < 3; ++c) tu[r * LDX + lane + 32 * c] = D::round(acc[i][c]);
      }
    }
    __syncthreads();

    // s = t xa^T: thread tile of 16 rows x 4 keys
    {
      const int rg = tid >> 6, jc = tid & 63;
      float acc[16][4];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
      for (int k = 0; k < H; k += 4) {
        float4 kv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(xs + (jc + 64 * jj) * LDX + k);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float4 tv = *reinterpret_cast<const float4*>(tu + (rg * 16 + i) * LDX + k);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = dot4(tv, kv[jj], acc[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = rg * 16 + i;
        const float tr = tc[r];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = jc + 64 * jj;
          ps[r * TMAX + j] = j < T ? acc[i][jj] + tr : -INFINITY;
        }
      }
    }
    __syncthreads();

    // softmax of this warp's rows, fp32 statistics
    for (int i = 0; i < RW; ++i) {
      float* pr = ps + (warp * RW + i) * TMAX;
      float v[TMAX / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < TMAX / 32; ++u) {
        v[u] = pr[lane + 32 * u];
        mx = fmaxf(mx, v[u]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < TMAX / 32; ++u) {
        v[u] = expf(v[u] - mx);
        sum += v[u];
      }
      sum = warp_sum(sum);
      float rsum = 0.f;
#pragma unroll
      for (int u = 0; u < TMAX / 32; ++u) {
        const float p = D::round(v[u] / sum);
        pr[lane + 32 * u] = p;
        rsum += p;
      }
      rsum = warp_sum(rsum);
      if (lane == 0) psum[warp * RW + i] = rsum;
    }
    __syncwarp();

    // u = p xa for this warp's rows; p is zero and xs rows are zero past T
    {
      float acc[RW][3];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[i][c] = 0.f;
      const int T4 = (T + 3) & ~3;
      for (int j = 0; j < T4; j += 4) {
        float xv[4][3];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < 3; ++c) xv[jj][c] = xs[(j + jj) * LDX + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 pv = *reinterpret_cast<const float4*>(ps + (warp * RW + i) * TMAX + j);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = acc[i][c];
            s = fmaf(pv.x, xv[0][c], s);
            s = fmaf(pv.y, xv[1][c], s);
            s = fmaf(pv.z, xv[2][c], s);
            acc[i][c] = fmaf(pv.w, xv[3][c], s);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) tu[(warp * RW + i) * LDX + lane + 32 * c] = acc[i][c];
    }
    __syncwarp();

    // o += u Wvo_h; the ones lane of xa brings row H of Wvo_h times sum(p)
    {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float wl = D::round(__ldg(Wh + H * HA + lane + 32 * c));
#pragma unroll
        for (int i = 0; i < RW; ++i) out[i][c] = fmaf(psum[warp * RW + i], wl, out[i][c]);
      }
      for (int k = 0; k < H; k += 4) {
        float w[4][3];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < 3; ++c) w[kk][c] = D::round(__ldg(Wh + (k + kk) * HA + lane + 32 * c));
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float4 uv = *reinterpret_cast<const float4*>(tu + (warp * RW + i) * LDX + k);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = out[i][c];
            s = fmaf(uv.x, w[0][c], s);
            s = fmaf(uv.y, w[1][c], s);
            s = fmaf(uv.z, w[2][c], s);
            out[i][c] = fmaf(uv.w, w[3][c], s);
          }
        }
      }
    }
    __syncwarp();  // the next head's t overwrites tu rows read above
  }

  // y = x + o + c, written once
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int q = q0 + warp * RW + i;
    if (q < T) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = lane + 32 * c;
        D::store(ym + q * H + k, out[i][c] + cvec[k] + D::load(xm + q * H + k));
      }
    }
  }
}

template <typename E>
cudaError_t launch(const void* x, const void* ln, const void* A, const void* Wvo,
                   const void* c, void* y, int M, int T, int nh, float eps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_block_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid(M, (T + QT - 1) / QT);
  attention_block_kernel<E><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(ln), static_cast<const float*>(A),
      static_cast<const float*>(Wvo), static_cast<const float*>(c), static_cast<E*>(y),
      T, nh, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: [M, T, H] float32, contiguous (bf16 inputs take attention_block_tc.cu).
// ln [2, H], A and Wvo [nh, H+2, H+2], c [H]: float32, contiguous.
// Returns the CUDA error of the launch (0 on success); shapes the kernel is
// not built for return cudaErrorInvalidValue without launching.
extern "C" int nbss_attention_block_fwd(const void* x, const void* ln, const void* A,
                                        const void* Wvo, const void* c, void* y,
                                        int M, int T, int Hdim, int nh, float eps,
                                        void* stream) {
  if (Hdim != H || T < 1 || T > TMAX || M < 1 || nh < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(launch<float>(x, ln, A, Wvo, c, y, M, T, nh, eps, s));
}
