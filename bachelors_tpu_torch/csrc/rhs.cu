// Hand-written CUDA kernels for the Allen-Cahn + heat right-hand side,
// compiled for Hopper (sm_90a) and called through a plain C interface from
// bachelors_tpu_torch/ops/cuda_rhs.py (ctypes).  Every entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// K1  bt_blend_rhs_f32: replaces `bachelors_tpu/ops/pallas_rhs.py:_make_kernel`
//     (:344) in modes "rhs" and "euler" (entry `blend_rhs_pallas` :555).
//     Blend of 1-4 states + boundary image + physics in one pass.
//     Bound on the card by bytes: it reads 2 fields per state and writes 2,
//     with ~100 flops per cell.  Design: one thread per cell, neighbours read
//     straight from device memory -- the 5-point stencil's reuse is caught by
//     L1/L2, and the blend of the k states happens in registers, so no
//     blended state is ever stored.  Measured with 4 states at 2048^2:
//     0.082 ms against a 0.050 ms byte floor (168 MB at 3.35 TB/s) on an
//     H100 80GB HBM3 at 700 W.
//
// K2  bt_rkm_attempt_f32: replaces `_make_fullstep_kernel` (:941) with
//     scheme "rkm" (entry `rkm_attempt_pallas` :1163): one whole Merson
//     attempt -- stages k1..k5, the update x + tau/6 (k1 + 4 k4 + k5), and
//     per-field maxima of |0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|.
//     It reads 2 fields and writes 2 (the staged path moves ~4 fields per
//     stage), a byte floor of 0.020 ms at 2048^2; it measured 0.373 ms there
//     (H100 80GB HBM3, 700 W), so this first version is bound by what it
//     computes, not by bytes: atan2f + cosf + ~60 flops per cell in each of
//     5 stages, on 1.42x the owned cells because of the shrinking apron,
//     all through shared memory.  Design: one block per 32x16 output tile.  The
//     tile plus a 5-cell apron on all four sides is loaded once into shared
//     memory; stage s is evaluated on the tile grown by 5 - s cells, so k1
//     is valid to depth 4, ..., k5 on the tile itself, and no stage value
//     ever leaves the SM.  Shared memory holds x, k1, k2 (reused for k3), k4
//     and the current blend for both fields: 10 arrays of 42x26 floats,
//     43.7 KB.  Per-block error maxima go to a partials buffer, reduced by a
//     second one-block kernel; both keep NaN.
//
// Boundary rule (both kernels).  At every stage the *blend* x + sum w_i k_i
// is imaged at the domain edge, with Dirichlet value d * (1 + sum w_i)
// (`pallas_rhs.py:1036-1052`, `bachelors_tpu/ops/rhs.py:15-22`).  The apron
// is indexed by unwrapped global coordinates and loaded with wrapped
// values.  A neighbour read that crosses a domain edge takes, for a
// Neumann/Dirichlet field, the image of the cell's own blend value, and for
// a periodic field the apron cell, whose stages were computed like an
// interior cell's.  Stage values at apron cells outside the domain are
// computed but read only by periodic fields, for which they are exactly the
// wrapped cell's values -- so mixed Phi/T boundary types are exact too.
#include <cuda_runtime.h>

#include "physics.cuh"

namespace bt {

// ---------------------------------------------------------------- K1 ----

constexpr int kK1BlockX = 32;
constexpr int kK1BlockY = 8;

struct BlendArgs {
  const float* F[4];
  const float* U[4];
  float w[4];  // w[0] is 1 and is not multiplied
};

template <int NS>
__device__ __forceinline__ float blend_at(const float* const* A,
                                          const float* w, int idx) {
  float v = A[0][idx];
#pragma unroll
  for (int k = 1; k < NS; ++k) v = v + A[k][idx] * w[k];
  return v;
}

template <int NS>
__global__ void __launch_bounds__(kK1BlockX* kK1BlockY)
    blend_rhs_kernel(BlendArgs a, float* __restrict__ outF,
                     float* __restrict__ outU, int ny, int nx, float d,
                     float fu, int is_euler, PhysParams P) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  bool cN = i + 1 == ny, cS = i == 0, cE = j + 1 == nx, cW = j == 0;
  int row = i * nx;
  int rowN = (cN ? 0 : i + 1) * nx, rowS = (cS ? ny - 1 : i - 1) * nx;
  int jE = cE ? 0 : j + 1, jW = cW ? nx - 1 : j - 1;

  float Fc = blend_at<NS>(a.F, a.w, row + j);
  float Uc = blend_at<NS>(a.U, a.w, row + j);
  // only touch a neighbour that the boundary rule actually reads
  auto nbF = [&](bool cross, int idx) {
    return (cross && P.f_bc != kPeriodic) ? neighbour(P.f_bc, true, 0.0f, Fc, d)
                                          : blend_at<NS>(a.F, a.w, idx);
  };
  auto nbU = [&](bool cross, int idx) {
    return (cross && P.u_bc != kPeriodic) ? neighbour(P.u_bc, true, 0.0f, Uc, d)
                                          : blend_at<NS>(a.U, a.w, idx);
  };
  float FN = nbF(cN, rowN + j), FS = nbF(cS, rowS + j);
  float FE = nbF(cE, row + jE), FW = nbF(cW, row + jW);
  float UN = nbU(cN, rowN + j), US = nbU(cS, rowS + j);
  float UE = nbU(cE, row + jE), UW = nbU(cW, row + jW);

  float dF, dU;
  physics(P, Fc, FN, FS, FE, FW, Uc, UN, US, UE, UW, fu, dF, dU);
  if (is_euler) {
    dF = Fc + P.dt * dF;
    dU = Uc + P.dt * dU;
  }
  outF[row + j] = dF;
  outU[row + j] = dU;
}

// ---------------------------------------------------------------- K2 ----

constexpr int kTX = 32;   // tile width (x, contiguous)
constexpr int kTY = 16;   // tile height (y)
constexpr int kApron = 5; // Merson reads 5 stages deep
constexpr int kRW = kTX + 2 * kApron;
constexpr int kRH = kTY + 2 * kApron;
constexpr int kRN = kRW * kRH;
constexpr int kK2Threads = 256;
constexpr int kReduceThreads = 256;

struct TileSmem {
  float xF[kRN], xU[kRN];    // the attempt's start state
  float k1F[kRN], k1U[kRN];
  float kaF[kRN], kaU[kRN];  // k2, then k3
  float k4F[kRN], k4U[kRN];
  float bF[kRN], bU[kRN];    // the current stage's blend
  float redF[kK2Threads], redU[kK2Threads];
};

// Where a tile's cells sit: region cell (ry, rx) is unwrapped global cell
// (gy0 + ry, gx0 + rx).
struct Tile {
  int gy0, gx0, ny, nx;
};

// k = f(b) on the tile grown by `depth` cells, b valid one cell deeper.
__device__ __forceinline__ void eval_stage(const Tile& T, const PhysParams& P,
                                           const float* bF, const float* bU,
                                           float* kF, float* kU, int depth,
                                           float dv, float fu) {
  const int w = kTX + 2 * depth, h = kTY + 2 * depth, lo = kApron - depth;
  for (int t = threadIdx.x; t < w * h; t += kK2Threads) {
    int ry = lo + t / w, rx = lo + t % w;
    int gy = T.gy0 + ry, gx = T.gx0 + rx;
    bool cN = wrap(gy + 1, T.ny) == 0, cS = wrap(gy, T.ny) == 0;
    bool cE = wrap(gx + 1, T.nx) == 0, cW = wrap(gx, T.nx) == 0;
    int c = ry * kRW + rx;
    float Fc = bF[c], Uc = bU[c];
    float dF, dU;
    physics(P, Fc, neighbour(P.f_bc, cN, bF[c + kRW], Fc, dv),
            neighbour(P.f_bc, cS, bF[c - kRW], Fc, dv),
            neighbour(P.f_bc, cE, bF[c + 1], Fc, dv),
            neighbour(P.f_bc, cW, bF[c - 1], Fc, dv), Uc,
            neighbour(P.u_bc, cN, bU[c + kRW], Uc, dv),
            neighbour(P.u_bc, cS, bU[c - kRW], Uc, dv),
            neighbour(P.u_bc, cE, bU[c + 1], Uc, dv),
            neighbour(P.u_bc, cW, bU[c - 1], Uc, dv), fu, dF, dU);
    kF[c] = dF;
    kU[c] = dU;
  }
}

// b = x + sum_i w_i k_i on the tile grown by `depth` cells, summed in order.
template <int NK>
__device__ __forceinline__ void eval_blend(TileSmem& s, const float* const* kF,
                                           const float* const* kU,
                                           const float* w, int depth) {
  const int wd = kTX + 2 * depth, h = kTY + 2 * depth, lo = kApron - depth;
  for (int t = threadIdx.x; t < wd * h; t += kK2Threads) {
    int c = (lo + t / wd) * kRW + lo + t % wd;
    float vF = s.xF[c], vU = s.xU[c];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      vF = vF + kF[k][c] * w[k];
      vU = vU + kU[k][c] * w[k];
    }
    s.bF[c] = vF;
    s.bU[c] = vU;
  }
}

__global__ void __launch_bounds__(kK2Threads)
    rkm_attempt_kernel(const float* __restrict__ F, const float* __restrict__ U,
                       float* __restrict__ outF, float* __restrict__ outU,
                       float* __restrict__ partials, int ny, int nx, float tau,
                       float d, float fu, PhysParams P) {
  __shared__ TileSmem s;
  const Tile T{int(blockIdx.y) * kTY - kApron, int(blockIdx.x) * kTX - kApron,
               ny, nx};

  for (int t = threadIdx.x; t < kRN; t += kK2Threads) {
    int g = wrap(T.gy0 + t / kRW, ny) * nx + wrap(T.gx0 + t % kRW, nx);
    s.xF[t] = F[g];
    s.xU[t] = U[g];
  }
  __syncthreads();

  // Merson tableau (`simulation.cu:400-404`); weights in float, as the
  // staged path computes them from a float tau
  eval_stage(T, P, s.xF, s.xU, s.k1F, s.k1U, 4, d, fu);
  __syncthreads();
  {
    const float* kF[1] = {s.k1F};
    const float* kU[1] = {s.k1U};
    const float w[1] = {tau / 3.0f};
    eval_blend<1>(s, kF, kU, w, 4);
    __syncthreads();
    eval_stage(T, P, s.bF, s.bU, s.kaF, s.kaU, 3, d * (1.0f + w[0]), fu);
    __syncthreads();
  }
  {
    const float* kF[2] = {s.k1F, s.kaF};
    const float* kU[2] = {s.k1U, s.kaU};
    const float w[2] = {tau / 6.0f, tau / 6.0f};
    eval_blend<2>(s, kF, kU, w, 3);
    __syncthreads();  // k2 is dead from here: k3 takes its arrays
    eval_stage(T, P, s.bF, s.bU, s.kaF, s.kaU, 2, d * (1.0f + w[0] + w[1]), fu);
    __syncthreads();
  }
  {
    const float* kF[2] = {s.k1F, s.kaF};
    const float* kU[2] = {s.k1U, s.kaU};
    const float w[2] = {tau / 8.0f, 3.0f * tau / 8.0f};
    eval_blend<2>(s, kF, kU, w, 2);
    __syncthreads();
    eval_stage(T, P, s.bF, s.bU, s.k4F, s.k4U, 1, d * (1.0f + w[0] + w[1]), fu);
    __syncthreads();
  }
  const float w5[3] = {tau / 2.0f, -3.0f * tau / 2.0f, 2.0f * tau};
  {
    const float* kF[3] = {s.k1F, s.kaF, s.k4F};
    const float* kU[3] = {s.k1U, s.kaU, s.k4U};
    eval_blend<3>(s, kF, kU, w5, 1);
    __syncthreads();
  }

  // k5 on the owned cells, the 5th-order update and the error combination
  const float dv = d * (1.0f + w5[0] + w5[1] + w5[2]);
  const float c6 = tau / 6.0f;
  float eF = 0.0f, eU = 0.0f;
  for (int t = threadIdx.x; t < kTX * kTY; t += kK2Threads) {
    int ry = kApron + t / kTX, rx = kApron + t % kTX;
    int gy = T.gy0 + ry, gx = T.gx0 + rx;
    if (gy >= ny || gx >= nx) continue;  // ragged tile edge
    bool cN = gy + 1 == ny, cS = gy == 0, cE = gx + 1 == nx, cW = gx == 0;
    int c = ry * kRW + rx;
    float Fc = s.bF[c], Uc = s.bU[c];
    float k5F, k5U;
    physics(P, Fc, neighbour(P.f_bc, cN, s.bF[c + kRW], Fc, dv),
            neighbour(P.f_bc, cS, s.bF[c - kRW], Fc, dv),
            neighbour(P.f_bc, cE, s.bF[c + 1], Fc, dv),
            neighbour(P.f_bc, cW, s.bF[c - 1], Fc, dv), Uc,
            neighbour(P.u_bc, cN, s.bU[c + kRW], Uc, dv),
            neighbour(P.u_bc, cS, s.bU[c - kRW], Uc, dv),
            neighbour(P.u_bc, cE, s.bU[c + 1], Uc, dv),
            neighbour(P.u_bc, cW, s.bU[c - 1], Uc, dv), fu, k5F, k5U);
    int g = gy * nx + gx;
    outF[g] = s.xF[c] + c6 * (s.k1F[c] + 4.0f * s.k4F[c] + k5F);
    outU[g] = s.xU[c] + c6 * (s.k1U[c] + 4.0f * s.k4U[c] + k5U);
    eF = nan_max(eF, fabsf(0.2f * s.k1F[c] - 0.9f * s.kaF[c] + 0.8f * s.k4F[c] - 0.1f * k5F));
    eU = nan_max(eU, fabsf(0.2f * s.k1U[c] - 0.9f * s.kaU[c] + 0.8f * s.k4U[c] - 0.1f * k5U));
  }

  s.redF[threadIdx.x] = eF;
  s.redU[threadIdx.x] = eU;
  __syncthreads();
  for (int half = kK2Threads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      s.redF[threadIdx.x] = nan_max(s.redF[threadIdx.x], s.redF[threadIdx.x + half]);
      s.redU[threadIdx.x] = nan_max(s.redU[threadIdx.x], s.redU[threadIdx.x + half]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[b] = s.redF[0];
    partials[gridDim.x * gridDim.y + b] = s.redU[0];
  }
}

// err[0] = max of partials[0:n], err[1] = max of partials[n:2n]
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ partials, int n,
                           float* __restrict__ err) {
  __shared__ float rF[kReduceThreads], rU[kReduceThreads];
  float mF = 0.0f, mU = 0.0f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    mF = nan_max(mF, partials[i]);
    mU = nan_max(mU, partials[n + i]);
  }
  rF[threadIdx.x] = mF;
  rU[threadIdx.x] = mU;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      rF[threadIdx.x] = nan_max(rF[threadIdx.x], rF[threadIdx.x + half]);
      rU[threadIdx.x] = nan_max(rU[threadIdx.x], rU[threadIdx.x + half]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    err[0] = rF[0];
    err[1] = rU[0];
  }
}

}  // namespace bt

using bt::PhysParams;

extern "C" {

// K1: out = f(sum_k w_k (F_k, U_k)), or the blend + dt * f in euler mode.
// F1..F3 / U1..U3 are ignored beyond n_states; w1..w3 weight them.
int bt_blend_rhs_f32(const float* F0, const float* U0, const float* F1,
                     const float* U1, const float* F2, const float* U2,
                     const float* F3, const float* U3, int n_states, float w1,
                     float w2, float w3, float* outF, float* outU, int ny,
                     int nx, float d, float fu, int is_euler,
                     const PhysParams* P, cudaStream_t stream) {
  bt::BlendArgs a{{F0, F1, F2, F3}, {U0, U1, U2, U3}, {1.0f, w1, w2, w3}};
  dim3 block(bt::kK1BlockX, bt::kK1BlockY);
  dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  switch (n_states) {
    case 1: bt::blend_rhs_kernel<1><<<grid, block, 0, stream>>>(a, outF, outU, ny, nx, d, fu, is_euler, *P); break;
    case 2: bt::blend_rhs_kernel<2><<<grid, block, 0, stream>>>(a, outF, outU, ny, nx, d, fu, is_euler, *P); break;
    case 3: bt::blend_rhs_kernel<3><<<grid, block, 0, stream>>>(a, outF, outU, ny, nx, d, fu, is_euler, *P); break;
    case 4: bt::blend_rhs_kernel<4><<<grid, block, 0, stream>>>(a, outF, outU, ny, nx, d, fu, is_euler, *P); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// Number of float pairs the K2 partials buffer holds (2 * this many floats).
int bt_rkm_num_blocks(int ny, int nx) {
  return ((nx + bt::kTX - 1) / bt::kTX) * ((ny + bt::kTY - 1) / bt::kTY);
}

// K2: one Merson attempt.  outF/outU get x + tau/6 (k1 + 4 k4 + k5);
// err[0], err[1] get max |0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5| of Phi and T
// (the caller scales by tau/3).  partials: 2 * bt_rkm_num_blocks floats.
int bt_rkm_attempt_f32(const float* F, const float* U, float* outF,
                       float* outU, float* partials, float* err, int ny,
                       int nx, float tau, float d, float fu,
                       const PhysParams* P, cudaStream_t stream) {
  dim3 grid((nx + bt::kTX - 1) / bt::kTX, (ny + bt::kTY - 1) / bt::kTY);
  bt::rkm_attempt_kernel<<<grid, bt::kK2Threads, 0, stream>>>(
      F, U, outF, outU, partials, ny, nx, tau, d, fu, *P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bt::reduce_partials_kernel<<<1, bt::kReduceThreads, 0, stream>>>(
      partials, int(grid.x * grid.y), err);
  return int(cudaGetLastError());
}

}  // extern "C"
