// Hand-written CUDA kernel for the fused field statistics, compiled for
// Hopper (sm_90a) and called through a plain C interface from
// bachelors_tpu_torch/ops/cuda_stats.py (ctypes).  The entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// K11 bt_field_stats: replaces `bachelors_tpu/ops/pallas_stats.py:
//     pallas_field_stats` (:38, kernel `_kernel` :27), the reduction
//     microbench's rival of the plain stats pass.  One read of a float32
//     array of n values gives {sum, L1 = sum|x| / n, L2 = sqrt(sum x^2 / n),
//     min, max}.  Bound by bytes: 4n read, ~5 operations per value, so at
//     2 * 4096^2 values 134 MB, 40 us at 3.35 TB/s.  Design: a grid-stride
//     pass, 16-byte loads where the array is 16-byte aligned, each thread
//     accumulating sum, sum|x| and sum x^2 in double (the H100's float64
//     rate keeps that far below the byte bound) and min and max in float;
//     warp shuffles and shared memory reduce them per block into a
//     (blocks, 5) partials buffer, and a one-block second launch adds the
//     partials in a fixed tree order and finishes the five values.  No
//     atomics and a grid fixed by n alone, so a result does not change from
//     run to run.  The TPU kernel needs n a multiple of 1024 (tiles of
//     (ty, 128)); this one takes any n >= 1.  min and max propagate NaN, as
//     torch.amin/amax and jnp.min/max do (fminf/fmaxf would drop it).
#include <cuda_runtime.h>

#include <cstdint>

namespace bt {

constexpr int kStatsThreads = 256;
constexpr int kStatsMaxBlocks = 1024;
constexpr int kStatsFinishThreads = 1024;
constexpr int kStatsValues = 5;  // sum, sum|x|, sum x^2, min, max

struct StatsAcc {
  double sum, l1, l2;
  float mn, mx;
};

// min and max that keep a NaN from either side
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

__device__ __forceinline__ StatsAcc stats_identity() {
  const float inf = __int_as_float(0x7f800000);
  return StatsAcc{0.0, 0.0, 0.0, inf, -inf};
}

__device__ __forceinline__ void stats_add(StatsAcc& a, float v) {
  const double d = double(v);
  a.sum += d;
  a.l1 += fabs(d);
  a.l2 += d * d;
  a.mn = nan_min(a.mn, v);
  a.mx = nan_max(a.mx, v);
}

__device__ __forceinline__ void stats_merge(StatsAcc& a, const StatsAcc& b) {
  a.sum += b.sum;
  a.l1 += b.l1;
  a.l2 += b.l2;
  a.mn = nan_min(a.mn, b.mn);
  a.mx = nan_max(a.mx, b.mx);
}

// The block's accumulators merged into thread 0's, in a fixed order.
template <int THREADS>
__device__ __forceinline__ StatsAcc stats_block_reduce(StatsAcc a) {
  __shared__ StatsAcc red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    StatsAcc b;
    b.sum = __shfl_down_sync(0xffffffffu, a.sum, off);
    b.l1 = __shfl_down_sync(0xffffffffu, a.l1, off);
    b.l2 = __shfl_down_sync(0xffffffffu, a.l2, off);
    b.mn = __shfl_down_sync(0xffffffffu, a.mn, off);
    b.mx = __shfl_down_sync(0xffffffffu, a.mx, off);
    stats_merge(a, b);
  }
  if (lane == 0) red[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < THREADS / 32 ? red[lane] : stats_identity();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      StatsAcc b;
      b.sum = __shfl_down_sync(0xffffffffu, a.sum, off);
      b.l1 = __shfl_down_sync(0xffffffffu, a.l1, off);
      b.l2 = __shfl_down_sync(0xffffffffu, a.l2, off);
      b.mn = __shfl_down_sync(0xffffffffu, a.mn, off);
      b.mx = __shfl_down_sync(0xffffffffu, a.mx, off);
      stats_merge(a, b);
    }
  }
  return a;
}

__global__ void __launch_bounds__(kStatsThreads)
    field_stats_kernel(const float* __restrict__ x, long long n, double* __restrict__ partials) {
  StatsAcc a = stats_identity();
  const long long stride = (long long)gridDim.x * kStatsThreads;
  const long long first = (long long)blockIdx.x * kStatsThreads + threadIdx.x;
  long long tail = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long k = first; k < n4; k += stride) {
      const float4 v = x4[k];
      stats_add(a, v.x);
      stats_add(a, v.y);
      stats_add(a, v.z);
      stats_add(a, v.w);
    }
    tail = 4 * n4;
  }
  for (long long k = tail + first; k < n; k += stride) stats_add(a, x[k]);
  a = stats_block_reduce<kStatsThreads>(a);
  if (threadIdx.x == 0) {
    double* out = partials + (long long)blockIdx.x * kStatsValues;
    out[0] = a.sum;
    out[1] = a.l1;
    out[2] = a.l2;
    out[3] = double(a.mn);
    out[4] = double(a.mx);
  }
}

// out = {sum, L1, L2, min, max} of the (blocks, 5) partials of n values.
__global__ void __launch_bounds__(kStatsFinishThreads)
    field_stats_finish_kernel(const double* __restrict__ partials, int blocks, long long n,
                              float* __restrict__ out) {
  StatsAcc a = stats_identity();
  for (int k = threadIdx.x; k < blocks; k += kStatsFinishThreads) {
    const double* p = partials + (long long)k * kStatsValues;
    stats_merge(a, StatsAcc{p[0], p[1], p[2], float(p[3]), float(p[4])});
  }
  a = stats_block_reduce<kStatsFinishThreads>(a);
  if (threadIdx.x == 0) {
    const double dn = double(n);
    out[0] = float(a.sum);
    out[1] = float(a.l1 / dn);
    out[2] = float(sqrt(a.l2 / dn));
    out[3] = a.mn;
    out[4] = a.mx;
  }
}

inline int stats_blocks(long long n) {
  const long long per_block = 4LL * kStatsThreads;
  const long long b = (n + per_block - 1) / per_block;
  return int(b < kStatsMaxBlocks ? (b < 1 ? 1 : b) : kStatsMaxBlocks);
}

}  // namespace bt

extern "C" {

// Values the partials buffer of K11 must hold for n values (blocks * 5).
int bt_field_stats_num_partials(long long n) { return bt::stats_blocks(n) * bt::kStatsValues; }

// K11: out[0:5] = {sum, sum|x| / n, sqrt(sum x^2 / n), min, max} of x[0:n],
// float32, n >= 1; partials holds bt_field_stats_num_partials(n) doubles.
int bt_field_stats_f32(const float* x, long long n, double* partials, float* out,
                       cudaStream_t stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  const int blocks = bt::stats_blocks(n);
  bt::field_stats_kernel<<<blocks, bt::kStatsThreads, 0, stream>>>(x, n, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bt::field_stats_finish_kernel<<<1, bt::kStatsFinishThreads, 0, stream>>>(partials, blocks, n,
                                                                           out);
  return int(cudaGetLastError());
}

}  // extern "C"
