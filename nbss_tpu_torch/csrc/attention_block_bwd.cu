// Narrow-band attention block, backward, for Hopper (sm_90a), float32 inputs
// on the CUDA cores; bf16 inputs take attention_block_bwd_tc.cu.
//
// The adjoint of attention_block.cu: given x [M, T, H = 96] and the cotangent
// g of y = x + sum_h softmax(xa A_h xa^T) (xa Wvo_h)[:, :H] + c, it returns
//
//     dx   [M, T, H]        in x's type,
//     dln  [2, H], dA, dWvo [nh, H+2, H+2], dc [1, H]   float32,
//
// recomputing the forward from (x, ln, A, Wvo) as the TPU kernel does.
// Replaces the Pallas TPU kernel _fused_block_bwd / _bwd_kernel in
// nbss_tpu/ops/attention_block.py, with its rounding points (identities in float32):
// t, vo, g' = g / rowsum(e), e (where it meets g'), dvo, dS and dt are rounded
// to x's type; every product accumulates in float32; dxa and the weight
// cotangents stay float32.
//
// What bounds it on an H100: arithmetic. At the training shape (M = 1032,
// T = 251, nh = 4) a call moves about 149 MB in bf16 (x, g, dx: 45 us at
// 3.35 TB/s); the unfolded backward is about 88 GFLOP (89 us at the bf16
// tensor-core peak), and the folded backward that this kernel computes, with
// the forward recomputed, about 2.4x more, here as fp32 FMA on the CUDA cores.
// As in the forward, the design answers the memory side and leaves the
// arithmetic to a later change (mma.sync / wgmma on bf16 operands): no [T, T]
// matrix reaches device memory.
//
// Layout. A persistent grid of G <= 132 blocks; block b takes the sequences
// m = b, b + G, ... and owns a slice of the float32 workspace that no other
// block touches:
//
//     VO  [TMAX][H]   vo = xa Wvo_h of the sequence (rounded), per head
//     DVO [TMAX][H]   dvo = e^T g', summed over the query tiles of a head
//     DXA [TMAX][H]   d LayerNorm(x), summed over heads and both sides
//     part[2 nh (H+2)^2 + 3H]   the block's sums of dA, dWvo, dln, dc
//
// Shared memory holds LayerNorm(x) of the whole sequence and, for one tile
// of 32 query rows, t, g', dt, the tile's e [32][256] and dS [32][256]
// (206 KB). A second small kernel sums the G partials in a fixed order, so
// the weight cotangents are deterministic (no atomics anywhere).
//
// Per sequence and head h:
//   A. vo = xa Wvo_h for every frame -> VO; DVO = 0
//   B. for each tile of 32 query rows q:
//      t = xa_q A_h; s = t xa^T (keys >= T masked by index); e = exp(s - max);
//      r = 1/sum(e); g' = g_q r; dP = g' vo^T; delta = r sum(dP e);
//      dS = e (dP - delta); dt = dS xa;
//      DVO += e^T g'; DXA_k += dS^T t; DXA_q += dt A_h^T; dA_h += xa_q^T dt
//   C. dWvo_h += xa^T dvo; DXA += dvo Wvo_h^T            (dvo = DVO rounded)
// and after the heads, the LayerNorm adjoint writes dx and sums dln and dc.
// Rows >= T contribute nothing to any sum; lane H+1 (the TPU kernel's pad
// lane) is zero for every real frame, so dt and dvo are zero there, and the
// cotangents of dvo's lanes H, H+1 are zero, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 96;         // channels the kernel is built for
constexpr int HA = H + 2;     // row stride of the folded operands
constexpr int TMAX = 256;     // longest sequence whose frames fit in shared memory
constexpr int QT = 32;        // query rows per tile
constexpr int NT = 256;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int RW = QT / NW;   // query rows owned by one warp
constexpr int LDX = H + 4;    // padded row stride (floats): 16-byte rows, no bank conflicts
constexpr int NI = (HA + NW - 1) / NW;  // rows of a [HA, *] outer product per warp

constexpr size_t SMEM_FLOATS = size_t(TMAX) * LDX   // xs: xa rows of the sequence
                             + 3 * size_t(QT) * LDX // ts, gp, dth
                             + 2 * size_t(QT) * TMAX  // es, ds (also scratch in C)
                             + QT;                  // rinv
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
static_assert(H == 3 * 32, "each lane owns three channels");
static_assert(2 * QT * TMAX >= 128 * H && 2 * QT * TMAX >= HA * H, "scratch too small");

constexpr size_t WS_ROWS = size_t(TMAX) * H;  // floats of VO, DVO, DXA each

__host__ __device__ constexpr size_t part_floats(int nh) { return 2 * size_t(nh) * HA * HA + 3 * H; }
__host__ __device__ constexpr size_t block_floats(int nh) { return 3 * WS_ROWS + part_floats(nh); }

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
attention_block_bwd_kernel(const E* __restrict__ x, const float* __restrict__ ln,
                           const float* __restrict__ A, const float* __restrict__ Wvo,
                           const E* __restrict__ g, E* __restrict__ dx, float* ws,
                           int M, int T, int nh, float eps) {
  using D = Elem<E>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [TMAX][LDX] xa = [LN(x), 1, 0, 0, 0]; rows >= T zero
  float* ts = xs + TMAX * LDX;      // [QT][LDX]   t of the tile (lanes 0..H)
  float* gp = ts + QT * LDX;        // [QT][LDX]   g' of the tile
  float* dth = gp + QT * LDX;       // [QT][LDX]   dt of the tile (lanes 0..H+1)
  float* es = dth + QT * LDX;       // [QT][TMAX]  e of the tile
  float* ds = es + QT * TMAX;       // [QT][TMAX]  dP, then dS
  float* rinv = ds + QT * TMAX;     // [QT]
  float* scratch = es;              // es and ds together, between tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* VO = ws + size_t(blockIdx.x) * block_floats(nh);
  float* DVO = VO + WS_ROWS;
  float* DXA = DVO + WS_ROWS;
  float* part = DXA + WS_ROWS;      // [dA: nh HA HA][dWvo: nh HA HA][dln: 2H][dc: H]
  float* pdA = part;
  float* pdW = part + size_t(nh) * HA * HA;

  for (size_t i = tid; i < 2 * size_t(nh) * HA * HA; i += NT) part[i] = 0.f;

  // dln and dc of this warp's rows, over every sequence of the block
  float acc_dl0[3] = {0.f, 0.f, 0.f}, acc_dl1[3] = {0.f, 0.f, 0.f}, acc_dc[3] = {0.f, 0.f, 0.f};

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const E* xm = x + size_t(m) * T * H;
    const E* gm = g + size_t(m) * T * H;
    __syncthreads();  // the previous sequence is done with xs and the workspace

    // 0. xa of every frame, rounded to the input type; DXA = 0
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
          DXA[j * H + k] = 0.f;
        }
        if (lane < 4) row[H + lane] = lane == 0 ? 1.f : 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) row[lane + 32 * c] = 0.f;
        if (lane < 4) row[H + lane] = 0.f;
      }
    }
    __syncthreads();

    for (int h = 0; h < nh; ++h) {
      const float* Ah = A + size_t(h) * HA * HA;
      const float* Wh = Wvo + size_t(h) * HA * HA;
      float* dAh = pdA + size_t(h) * HA * HA;
      float* dWh = pdW + size_t(h) * HA * HA;

      // A. vo = xa Wvo_h (lanes < H) for every frame; DVO = 0
      for (int j0 = warp * 4; j0 < T; j0 += NW * 4) {
        float acc[4][3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float b = D::round(__ldg(Wh + H * HA + lane + 32 * c));  // the ones lane
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = b;
        }
        for (int k = 0; k < H; k += 4) {
          float w[4][3];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 0; c < 3; ++c) w[kk][c] = D::round(__ldg(Wh + (k + kk) * HA + lane + 32 * c));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 xv = *reinterpret_cast<const float4*>(xs + (j0 + i) * LDX + k);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float s = acc[i][c];
              s = fmaf(xv.x, w[0][c], s);
              s = fmaf(xv.y, w[1][c], s);
              s = fmaf(xv.z, w[2][c], s);
              acc[i][c] = fmaf(xv.w, w[3][c], s);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 + i < T) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              VO[(j0 + i) * H + lane + 32 * c] = D::round(acc[i][c]);
              DVO[(j0 + i) * H + lane + 32 * c] = 0.f;
            }
          }
        }
      }
      __syncthreads();

      // B. query tiles
      for (int q0 = 0; q0 < T; q0 += QT) {
        // B1. t = xa_q A_h for this warp's rows; lane H of t is a warp sum
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
            const bool valid = q0 + r < T;
            const float* xr = xs + (q0 + r) * LDX;
            float p = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) p = fmaf(xr[lane + 32 * c], acol[c], p);
            p = warp_sum(p) + a_hh;
#pragma unroll
            for (int c = 0; c < 3; ++c) ts[r * LDX + lane + 32 * c] = valid ? D::round(acc[i][c]) : 0.f;
            if (lane < 4) ts[r * LDX + H + lane] = (lane == 0 && valid) ? D::round(p) : 0.f;
          }
        }
        __syncthreads();

        // B2. s = t xa^T: thread tile of 8 rows x 4 keys; keys >= T get -inf
        {
          const int rg = tid >> 6, jc = tid & 63;
          float acc[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
          for (int k = 0; k < LDX; k += 4) {  // lanes H.. of ts and xs: [t_H, 0, 0, 0] . [1, 0, 0, 0]
            float4 kv[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              kv[jj] = *reinterpret_cast<const float4*>(xs + (jc + 64 * jj) * LDX + k);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 tv = *reinterpret_cast<const float4*>(ts + (rg * 8 + i) * LDX + k);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) acc[i][jj] = dot4(tv, kv[jj], acc[i][jj]);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = jc + 64 * jj;
              es[(rg * 8 + i) * TMAX + j] = j < T ? acc[i][jj] : -INFINITY;
            }
        }
        __syncthreads();

        // B3. e = exp(s - max), r = 1/sum(e), g' = g r for this warp's rows;
        // rows >= T are zero throughout
        for (int i = 0; i < RW; ++i) {
          const int r = warp * RW + i, q = q0 + r;
          float* er = es + r * TMAX;
          if (q < T) {
            float v[TMAX / 32];
            float mx = -INFINITY;
#pragma unroll
            for (int u = 0; u < TMAX / 32; ++u) {
              v[u] = er[lane + 32 * u];
              mx = fmaxf(mx, v[u]);
            }
            mx = warp_max(mx);
            float sum = 0.f;
#pragma unroll
            for (int u = 0; u < TMAX / 32; ++u) {
              v[u] = expf(v[u] - mx);
              sum += v[u];
              er[lane + 32 * u] = v[u];
            }
            const float ri = 1.f / warp_sum(sum);
            if (lane == 0) rinv[r] = ri;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const int k = lane + 32 * c;
              gp[r * LDX + k] = D::round(D::load(gm + q * H + k) * ri);
            }
          } else {
#pragma unroll
            for (int u = 0; u < TMAX / 32; ++u) er[lane + 32 * u] = 0.f;
            if (lane == 0) rinv[r] = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) gp[r * LDX + lane + 32 * c] = 0.f;
          }
        }
        __syncthreads();

        // B4. dP = g' vo^T: thread tile of 8 rows x 4 keys, vo from the workspace
        {
          const int rg = tid >> 6, jc = tid & 63;
          float acc[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
          int jrow[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) jrow[jj] = min(jc + 64 * jj, T - 1);  // rows >= T: masked below
          for (int k = 0; k < H; k += 4) {
            float4 kv[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              kv[jj] = *reinterpret_cast<const float4*>(VO + jrow[jj] * H + k);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 gv = *reinterpret_cast<const float4*>(gp + (rg * 8 + i) * LDX + k);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) acc[i][jj] = dot4(gv, kv[jj], acc[i][jj]);
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = jc + 64 * jj;
              ds[(rg * 8 + i) * TMAX + j] = j < T ? acc[i][jj] : 0.f;
            }
        }
        __syncthreads();

        // B5. delta = r sum_j dP e; dS = e (dP - delta), rounded; then
        // dt = dS xa for this warp's rows (lane H: the row sum of dS)
        for (int i = 0; i < RW; ++i) {
          const int r = warp * RW + i;
          float* er = es + r * TMAX;
          float* dr = ds + r * TMAX;
          float dp[TMAX / 32];
          float part_sum = 0.f;
#pragma unroll
          for (int u = 0; u < TMAX / 32; ++u) {
            dp[u] = dr[lane + 32 * u];
            part_sum = fmaf(dp[u], er[lane + 32 * u], part_sum);
          }
          const float delta = warp_sum(part_sum) * rinv[r];
#pragma unroll
          for (int u = 0; u < TMAX / 32; ++u)
            dr[lane + 32 * u] = D::round(er[lane + 32 * u] * (dp[u] - delta));
        }
        __syncwarp();
        {
          float acc[RW][3], acc1[RW];
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            acc1[i] = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[i][c] = 0.f;
          }
          const int T4 = (T + 3) & ~3;  // dS is zero and xs rows are zero past T
          for (int j = 0; j < T4; j += 4) {
            float xv[4][3];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int c = 0; c < 3; ++c) xv[jj][c] = xs[(j + jj) * LDX + lane + 32 * c];
#pragma unroll
            for (int i = 0; i < RW; ++i) {
              const float4 pv = *reinterpret_cast<const float4*>(ds + (warp * RW + i) * TMAX + j);
              acc1[i] += (pv.x + pv.y) + (pv.z + pv.w);
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
          for (int i = 0; i < RW; ++i) {
            const int r = warp * RW + i;
#pragma unroll
            for (int c = 0; c < 3; ++c) dth[r * LDX + lane + 32 * c] = D::round(acc[i][c]);
            if (lane < 4) dth[r * LDX + H + lane] = lane == 0 ? D::round(acc1[i]) : 0.f;
          }
        }
        __syncthreads();

        // B6. key side: DVO_k += sum_q e_qk g'_q (e rounded), DXA_k += sum_q dS_qk t_q
        for (int k0 = warp * 4; k0 < T; k0 += NW * 4) {
          float av[4][3], ax[4][3];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 0; c < 3; ++c) av[kk][c] = ax[kk][c] = 0.f;
          for (int r = 0; r < QT; ++r) {
            const float4 e4 = *reinterpret_cast<const float4*>(es + r * TMAX + k0);
            const float4 d4 = *reinterpret_cast<const float4*>(ds + r * TMAX + k0);
            const float ev[4] = {D::round(e4.x), D::round(e4.y), D::round(e4.z), D::round(e4.w)};
            const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float gv = gp[r * LDX + lane + 32 * c];
              const float tv = ts[r * LDX + lane + 32 * c];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                av[kk][c] = fmaf(ev[kk], gv, av[kk][c]);
                ax[kk][c] = fmaf(dv[kk], tv, ax[kk][c]);
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (k0 + kk < T) {
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                const int o = (k0 + kk) * H + lane + 32 * c;
                DVO[o] += av[kk][c];
                DXA[o] += ax[kk][c];
              }
            }
          }
        }
        __syncthreads();

        // B7. A_h^T, rounded, into the scratch: at[k][i] = A_h[i][k]
        for (int idx = tid; idx < H * HA; idx += NT) {
          const int i = idx / HA, k = idx - i * HA;
          scratch[k * H + i] = D::round(__ldg(Ah + idx));
        }
        __syncthreads();

        // B8. query side: DXA_q += dt A_h^T (rows of this warp)
        {
          float acc[RW][3];
#pragma unroll
          for (int i = 0; i < RW; ++i)
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[i][c] = 0.f;
          for (int k = 0; k < HA; ++k) {
            float a[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) a[c] = scratch[k * H + lane + 32 * c];
#pragma unroll
            for (int i = 0; i < RW; ++i) {
              const float d = dth[(warp * RW + i) * LDX + k];
#pragma unroll
              for (int c = 0; c < 3; ++c) acc[i][c] = fmaf(d, a[c], acc[i][c]);
            }
          }
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const int q = q0 + warp * RW + i;
            if (q < T) {
#pragma unroll
              for (int c = 0; c < 3; ++c) DXA[q * H + lane + 32 * c] += acc[i][c];
            }
          }
        }

        // B9. dA_h += xa_q^T dt: rows i = warp + NW n, columns k = lane + 32 u
        {
          float acc[NI][4];
#pragma unroll
          for (int n = 0; n < NI; ++n)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;
          for (int r = 0; r < QT; ++r) {
            float d[4];
#pragma unroll
            for (int u = 0; u < 3; ++u) d[u] = dth[r * LDX + lane + 32 * u];
            d[3] = lane < 2 ? dth[r * LDX + H + lane] : 0.f;
            const float* xr = xs + (q0 + r) * LDX;
#pragma unroll
            for (int n = 0; n < NI; ++n) {
              const int i = warp + NW * n;
              const float xv = i < HA ? xr[i] : 0.f;
#pragma unroll
              for (int u = 0; u < 4; ++u) acc[n][u] = fmaf(xv, d[u], acc[n][u]);
            }
          }
#pragma unroll
          for (int n = 0; n < NI; ++n) {
            const int i = warp + NW * n;
            if (i < HA) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int k = lane + 32 * u;
                if (k < HA) dAh[i * HA + k] += acc[n][u];
              }
            }
          }
        }
        __syncthreads();  // the next tile overwrites ts, gp, dth, es, ds
      }

      // C1. dWvo_h[:, :H] += xa^T dvo, over chunks of 128 frames staged in the scratch
      {
        float acc[NI][3];
#pragma unroll
        for (int n = 0; n < NI; ++n)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[n][c] = 0.f;
        for (int j0 = 0; j0 < T; j0 += 128) {
          const int nj = min(128, T - j0);
          for (int idx = tid; idx < nj * H; idx += NT) scratch[idx] = D::round(DVO[j0 * H + idx]);
          __syncthreads();
          for (int jj = 0; jj < nj; ++jj) {
            float d[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) d[c] = scratch[jj * H + lane + 32 * c];
            const float* xr = xs + (j0 + jj) * LDX;
#pragma unroll
            for (int n = 0; n < NI; ++n) {
              const int i = warp + NW * n;
              const float xv = i < HA ? xr[i] : 0.f;
#pragma unroll
              for (int c = 0; c < 3; ++c) acc[n][c] = fmaf(xv, d[c], acc[n][c]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int n = 0; n < NI; ++n) {
          const int i = warp + NW * n;
          if (i < HA) {
#pragma unroll
            for (int c = 0; c < 3; ++c) dWh[i * HA + lane + 32 * c] += acc[n][c];
          }
        }
      }

      // C2. DXA += dvo Wvo_h[:, :H]^T, with wt[k][i] = Wvo_h[i][k] rounded in the scratch
      for (int idx = tid; idx < H * H; idx += NT) {
        const int i = idx / H, k = idx - i * H;
        scratch[k * H + i] = D::round(__ldg(Wh + i * HA + k));
      }
      __syncthreads();
      for (int j0 = warp * 4; j0 < T; j0 += NW * 4) {
        float acc[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[i][c] = 0.f;
        int jrow[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) jrow[i] = min(j0 + i, T - 1);
        for (int k = 0; k < H; k += 4) {
          float w[4][3];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 0; c < 3; ++c) w[kk][c] = scratch[(k + kk) * H + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 dv = *reinterpret_cast<const float4*>(DVO + jrow[i] * H + k);
            const float d[4] = {D::round(dv.x), D::round(dv.y), D::round(dv.z), D::round(dv.w)};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float s = acc[i][c];
              s = fmaf(d[0], w[0][c], s);
              s = fmaf(d[1], w[1][c], s);
              s = fmaf(d[2], w[2][c], s);
              acc[i][c] = fmaf(d[3], w[3][c], s);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 + i < T) {
#pragma unroll
            for (int c = 0; c < 3; ++c) DXA[(j0 + i) * H + lane + 32 * c] += acc[i][c];
          }
        }
      }
      __syncthreads();  // the next head overwrites VO, DVO and the scratch
    }

    // D. LayerNorm adjoint: dx = g + rsig (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
    for (int j = warp; j < T; j += NW) {
      float v[3], gv[3], dl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = lane + 32 * c;
        v[c] = D::load(xm + j * H + k);
        gv[c] = D::load(gm + j * H + k);
        dl[c] = DXA[j * H + k];
      }
      const float mu = warp_sum(v[0] + v[1] + v[2]) / float(H);
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] -= mu;
        d2 = fmaf(v[c], v[c], d2);
      }
      const float rs = rsqrtf(warp_sum(d2) / float(H) + eps);
      float xhat[3], dxh[3], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int k = lane + 32 * c;
        xhat[c] = v[c] * rs;
        dxh[c] = dl[c] * ln[k];
        s1 += dxh[c];
        s2 = fmaf(dxh[c], xhat[c], s2);
        acc_dl0[c] = fmaf(dl[c], xhat[c], acc_dl0[c]);
        acc_dl1[c] += dl[c];
        acc_dc[c] += gv[c];
      }
      const float m1 = warp_sum(s1) / float(H), m2 = warp_sum(s2) / float(H);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        D::store(dx + size_t(m) * T * H + j * H + lane + 32 * c,
                 gv[c] + rs * (dxh[c] - m1 - xhat[c] * m2));
    }
  }

  // the block's dln and dc: warps summed in a fixed order
  __syncthreads();
  float* red = scratch;  // [NW][3H]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int k = lane + 32 * c;
    red[warp * 3 * H + k] = acc_dl0[c];
    red[warp * 3 * H + H + k] = acc_dl1[c];
    red[warp * 3 * H + 2 * H + k] = acc_dc[c];
  }
  __syncthreads();
  for (int k = tid; k < 3 * H; k += NT) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w * 3 * H + k];
    part[2 * size_t(nh) * HA * HA + k] = s;
  }
}

// out[e] = sum over blocks b, in order, of block b's part[e]
__global__ void attention_block_bwd_reduce(const float* __restrict__ ws, float* __restrict__ out,
                                           int nblocks, int nh) {
  const size_t n = part_floats(nh), stride = block_floats(nh);
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += ws[b * stride + 3 * WS_ROWS + e];
    out[e] = s;
  }
}

template <typename E>
cudaError_t launch(const void* x, const void* ln, const void* A, const void* Wvo, const void* g,
                   void* dx, void* out, void* ws, int nblocks, int M, int T, int nh, float eps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_block_bwd_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  attention_block_bwd_kernel<E><<<nblocks, NT, SMEM_BYTES, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(ln), static_cast<const float*>(A),
      static_cast<const float*>(Wvo), static_cast<const E*>(g), static_cast<E*>(dx),
      static_cast<float*>(ws), M, T, nh, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = int(part_floats(nh));
  attention_block_bwd_reduce<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), nblocks, nh);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace that each block of the backward needs, for nh heads.
extern "C" long long nbss_attention_block_bwd_workspace_floats(int nh) {
  return static_cast<long long>(block_floats(nh));
}

// x, g, dx: [M, T, H] float32, contiguous (bf16 inputs take attention_block_bwd_tc.cu).
// ln [2, H], A and Wvo [nh, H+2, H+2]: float32, contiguous.
// out: float32 [2 nh (H+2)^2 + 3H] = dA, dWvo, dln, dc one after another.
// ws: float32, nblocks * nbss_attention_block_bwd_workspace_floats(nh), any content.
// Returns the CUDA error of the launches (0 on success); shapes the kernel is
// not built for return cudaErrorInvalidValue without launching.
extern "C" int nbss_attention_block_bwd(const void* x, const void* ln, const void* A,
                                        const void* Wvo, const void* g, void* dx, void* out,
                                        void* ws, int nblocks, int M, int T, int Hdim, int nh,
                                        float eps, void* stream) {
  if (Hdim != H || T < 1 || T > TMAX || M < 1 || nh < 1 || nblocks < 1 || nblocks > M)
    return int(cudaErrorInvalidValue);
  return int(launch<float>(x, ln, A, Wvo, g, dx, out, ws, nblocks, M, T, nh, eps,
                           static_cast<cudaStream_t>(stream)));
}
