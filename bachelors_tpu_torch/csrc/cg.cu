// Hand-written CUDA kernels for the conjugate-gradient loop of the
// semi-implicit solver, compiled for Hopper (sm_90a) and called through a
// plain C interface from bachelors_tpu_torch/ops/cuda_cg.py (ctypes).  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().  Scalars that the loop computes on the device
// (alpha, a, b) are read through pointers, so the host never fetches them.
//
// K8  bt_matvec_pAp_f32: replaces `bachelors_tpu/ops/pallas_cg.py:_matvec_pAp`
//     (:49) with blend=False (entries `cross_matvec_pAp` :205 and
//     `aniso_matvec_pAp` :214).  Ap for the 5-point operator, either the
//     constant cross form C p + X (E+W) + Y (N+S) or the per-cell form
//     (1 + C s) p + X s (E+W) + Y s (N+S), and <p, Ap> from the same read of
//     p.  Ghosts take Dirichlet value 0: the CG vectors are deltas.  Bound
//     by bytes (1 or 2 fields read, 1 written, ~10 flops per cell).  Design:
//     one thread per cell, neighbours from device memory (L1/L2 catch the
//     stencil's reuse), a shared-memory block sum of p Ap into one partial
//     per block, then a one-block kernel adds the partials.  The output may
//     be a dead buffer the caller passes in, never p (the wrapper checks).
//
// K9  bt_update_xr_rr_f32: replaces `pallas_cg.py:_update_xr_rr` (:310,
//     entry `update_xr_rr` :343).  x += alpha p and r -= alpha Ap in place,
//     and <r', r'> of the new r: block partials, then the one-block sum.
//     Pointwise, so in place is safe.  Bound by bytes (4 fields read, 2
//     written).
//
// K10 bt_axpby_f32: replaces `pallas_cg.py:_axpby_inplace` (:274, entry
//     `axpby_inplace` :300).  p = a r + b p in place.  Bound by bytes.
//
// The partial sums are added by a second kernel (`sum_partials_kernel`),
// as K2's error maxima are, never by a library reduction.  Block sums run
// in a fixed tree order, so a result does not change from run to run; it
// differs from torch.sum's order by ~1e-7 relative in float32.
#include <cuda_runtime.h>

#include "physics.cuh"

namespace bt {

constexpr int kCgBlockX = 32;
constexpr int kCgBlockY = 8;
constexpr int kCgThreads = kCgBlockX * kCgBlockY;
constexpr int kSumThreads = 1024;

// Sum of v over the block's threads (a multiple of 32), valid in thread 0.
// `red` holds one float per warp.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < THREADS / 32 ? red[tid] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------- K8 ----

template <bool WITH_S>
__global__ void __launch_bounds__(kCgThreads)
    matvec_pAp_kernel(const float* __restrict__ p, const float* __restrict__ s,
                      float* __restrict__ out, float* __restrict__ partials,
                      int ny, int nx, int bc, float C, float X, float Y) {
  __shared__ float red[kCgThreads / 32];
  const int j = blockIdx.x * kCgBlockX + threadIdx.x;
  const int i = blockIdx.y * kCgBlockY + threadIdx.y;
  float pAp = 0.0f;
  if (i < ny && j < nx) {
    const int c = i * nx + j;
    const float pc = p[c];
    const Cross n = cross_of(p, bc, pc, 0.0f, i, j, ny, nx);
    float Av;
    if (WITH_S) {
      const float sv = s[c];
      Av = (1.0f + C * sv) * pc + (X * sv) * (n.E + n.W) + (Y * sv) * (n.N + n.S);
    } else {
      Av = C * pc + X * (n.E + n.W) + Y * (n.N + n.S);
    }
    out[c] = Av;
    pAp = pc * Av;
  }
  const float total = block_sum<kCgThreads>(pAp, red);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// ---------------------------------------------------------------- K9 ----

__global__ void __launch_bounds__(kCgThreads)
    update_xr_rr_kernel(float* __restrict__ x, float* __restrict__ r,
                        const float* __restrict__ p, const float* __restrict__ Ap,
                        const float* __restrict__ alpha,
                        float* __restrict__ partials, int n) {
  __shared__ float red[kCgThreads / 32];
  const int c = blockIdx.x * kCgThreads + threadIdx.x;
  float rr = 0.0f;
  if (c < n) {
    const float a = *alpha;
    x[c] = x[c] + a * p[c];
    const float rn = r[c] - a * Ap[c];
    r[c] = rn;
    rr = rn * rn;
  }
  const float total = block_sum<kCgThreads>(rr, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// --------------------------------------------------------------- K10 ----

__global__ void __launch_bounds__(kCgThreads)
    axpby_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ r, float* __restrict__ p, int n) {
  const int c = blockIdx.x * kCgThreads + threadIdx.x;
  if (c < n) p[c] = (*a) * r[c] + (*b) * p[c];
}

// ------------------------------------------------------- partial sums ----

// out[0] = sum of partials[0:n], in one block and a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    sum_partials_kernel(const float* __restrict__ partials, int n,
                        float* __restrict__ out) {
  __shared__ float red[kSumThreads / 32];
  float v = 0.0f;
  for (int k = threadIdx.x; k < n; k += kSumThreads) v += partials[k];
  const float total = block_sum<kSumThreads>(v, red);
  if (threadIdx.x == 0) out[0] = total;
}

inline dim3 matvec_grid(int ny, int nx) {
  return dim3((nx + kCgBlockX - 1) / kCgBlockX, (ny + kCgBlockY - 1) / kCgBlockY);
}

inline int pointwise_blocks(int n) { return (n + kCgThreads - 1) / kCgThreads; }

}  // namespace bt

extern "C" {

// Floats the partials buffer of K8 and K9 must hold for a (ny, nx) field.
int bt_cg_num_partials(int ny, int nx) {
  dim3 g = bt::matvec_grid(ny, nx);
  int a = int(g.x * g.y), b = bt::pointwise_blocks(ny * nx);
  return a > b ? a : b;
}

// K8: out = A p and pAp[0] = <p, A p>.  s null: the cross operator
// C p + X (E+W) + Y (N+S); s given: (1 + C s) p + X s (E+W) + Y s (N+S).
// bc: the field's BoundaryType (0 periodic, 1 Neumann, 2 Dirichlet at 0).
// out must not overlap p.
int bt_matvec_pAp_f32(const float* p, const float* s, float* out,
                      float* partials, float* pAp, int ny, int nx, int bc,
                      float C, float X, float Y, cudaStream_t stream) {
  dim3 grid = bt::matvec_grid(ny, nx);
  dim3 block(bt::kCgBlockX, bt::kCgBlockY);
  if (s != nullptr)
    bt::matvec_pAp_kernel<true><<<grid, block, 0, stream>>>(p, s, out, partials, ny, nx, bc, C, X, Y);
  else
    bt::matvec_pAp_kernel<false><<<grid, block, 0, stream>>>(p, s, out, partials, ny, nx, bc, C, X, Y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bt::sum_partials_kernel<<<1, bt::kSumThreads, 0, stream>>>(partials, int(grid.x * grid.y), pAp);
  return int(cudaGetLastError());
}

// K9: x += alpha p, r -= alpha Ap (in place, n cells), rr[0] = <r, r>.
int bt_update_xr_rr_f32(float* x, float* r, const float* p, const float* Ap,
                        const float* alpha, float* partials, float* rr, int n,
                        cudaStream_t stream) {
  int blocks = bt::pointwise_blocks(n);
  bt::update_xr_rr_kernel<<<blocks, bt::kCgThreads, 0, stream>>>(x, r, p, Ap, alpha, partials, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bt::sum_partials_kernel<<<1, bt::kSumThreads, 0, stream>>>(partials, blocks, rr);
  return int(cudaGetLastError());
}

// K10: p = a r + b p in place (n cells); a, b are device scalars.
int bt_axpby_f32(const float* a, const float* b, const float* r, float* p, int n,
                 cudaStream_t stream) {
  bt::axpby_kernel<<<bt::pointwise_blocks(n), bt::kCgThreads, 0, stream>>>(a, b, r, p, n);
  return int(cudaGetLastError());
}

}  // extern "C"
