// The tutorial's six kernels, hand-written in CUDA C++ for Hopper (sm_90a)
// and called through a plain C interface from
// bachelors_tpu_torch/ops/cuda_tutorial.py (ctypes).  Each entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError().  They replace the six Pallas kernels of
// examples/pallas_tutorial.py, and teach what a CUDA kernel does where the
// Pallas one leans on BlockSpecs, VMEM and SMEM:
//
// K15.1 bt_tut_saxpy_whole (`saxpy_whole` :40, pallas_call :44): o = a x + y
//     over a flat grid, one range of values per block, `a` passed by value.
//     The TPU kernel holds the whole array in VMEM at once; here the grid
//     covers it.
// K15.2 bt_tut_saxpy_rows (`saxpy_gridded` :54, :61): the same over a grid
//     of row tiles.  The grid walking tiles with coalesced 16-byte loads is
//     the CUDA analogue of a BlockSpec pipeline copying (128, nx) tiles HBM
//     -> VMEM.  The rows are contiguous, so a tile of R rows is one range
//     of R nx values: R is as many rows as a block takes (at least one), and
//     a longer tile is cut into block-sized pieces, consecutive blocks on
//     consecutive memory.  Any number of rows, the last tile ragged: the TPU
//     kernel drops rows past the last whole 128-row block.
// K15.3 bt_tut_saxpy_rows_dev (`saxpy_smem` :70, :77): K15.2 with `a` read
//     through a pointer from a one-element device tensor, once per thread,
//     the analogue of the (1, 1) SMEM operand.  One launch configuration
//     (or one captured CUDA graph) serves every `a`, and an earlier kernel
//     can write `a` without a host sync, which is how the port's CG keeps
//     alpha and beta on the device (K9, K8b).
//     The three saxpys are bound by bytes: 12 a value, 201 MB and 60.1 us at
//     4096^2 at 3.35 TB/s.  Their first design (one 4-byte value a thread
//     for K15.1; for K15.2/K15.3 4-row tiles walked row by row, one float4
//     pair a thread in flight, 1024 blocks at 4096^2, most threads idle on
//     rows under 1024 values, a whole misaligned row in scalar code) lost
//     5-9% to torch.add's vectorized loop there.  Now each block walks one
//     range in one routine (`saxpy_range`): 256 threads, one 16-byte vector
//     of each input a thread per pass, alignment reckoned once a range, and
//     where x, y and o differ in 16-byte phase (a view at an odd storage
//     offset) a scalar pass as deep, so as many bytes stay in flight.  A block takes one pass (1024
//     values), fewer where that would leave under two blocks an SM (down to
//     a warp's 128 values).  An array that fits in one wave of the card's
//     threads is launch- and latency-bound: there K15.1 gives each thread
//     one value (`tut_saxpy_wave_kernel`), the shortest chain from launch
//     to store.  Measured and not kept (PERF.md): two or four vectors a
//     thread, 128 threads, evict-first loads and stores, a persistent grid.
//     Each value is __fadd_rn(__fmul_rn(a, x), y), two roundings as
//     saxpy_plain and the JAX tutorial: no FMA.
// K15.4 bt_tut_block_sum (`block_sum` :88, :95): sum x.  A float32
//     grid-stride sum per thread (float4 loads where aligned), then warp
//     shuffles and shared memory give one partial per block; a second,
//     one-block launch adds the partials in a fixed tree.  No atomics and a
//     grid fixed by n, so repeated calls give the same bits.  The TPU kernel
//     writes one partial per (128, nx) block and drops the ragged tail.
// K15.5 bt_tut_laplacian (`laplacian_halo` :108, :127): N + S + E + W - 4 c
//     with edge replication at all four borders (= jnp.pad(x, 1, "edge")).
//     A 32 x 32 output tile is computed from a 34 x 34 shared-memory tile
//     loaded cooperatively; the load index is clamped to the grid, which is
//     the edge replication, so the halo machinery of the TPU kernel (index
//     maps fetching neighbour row groups) is one clamp.  N is the row below
//     in memory (pltpu.roll(c, ty - 1, 0) gives c[i + 1]), S the row above.
//     Every operation is rounded on its own (__fadd_rn, __fmul_rn) in the
//     JAX order, so the plain torch version is matched bit for bit.
// K15.6 bt_tut_fused_stats (`fused_stats` :144, :157): {sum x, sum |x|, min,
//     max} in one read, with K15.4's two-launch shape.  The sums are float32
//     as the tutorial's are; min and max propagate NaN with an explicit
//     test, as jnp.min and K11 do (fminf/fmaxf would drop it).  It is not
//     K11 (csrc/stats.cu): no L2, no means, no float64 accumulators.
//
// All six are bound by bytes: saxpy moves 12 bytes and does 2 operations a
// value, the sums read 4 bytes for 1 or 4 operations, the Laplacian 8 bytes
// for 5; at 4096^2 that is 60 us (saxpy), 20 us (sums) and 40 us
// (Laplacian) at 3.35 TB/s.  Each takes any size of at least one float32
// value, contiguous (a view at any storage offset).
#include <cuda_runtime.h>

#include <cstdint>

namespace bt {

constexpr int kTutThreads = 256;  // K15.4, K15.6
constexpr int kTutMaxBlocks = 1024;
constexpr int kTutFinishThreads = 1024;
constexpr int kTutStats = 4;  // sum, sum|x|, min, max
constexpr int kLapTile = 32;  // output tile of K15.5, 32 x 32
constexpr int kLapRowsPerThread = 4;  // blocks of 32 x 8 threads

// K15.1-K15.3 ---------------------------------------------------------------

constexpr int kSaxpyThreads = 256;
constexpr int kSaxpyWork = 4 * kSaxpyThreads;  // values a block takes per pass
constexpr int kSaxpyFillBlocks = 2 * 132;  // two blocks for each of the H100's 132 SMs
constexpr int kSaxpyWave = 132 * 2048;  // K15.1: one value for each thread the card holds

__device__ __forceinline__ float saxpy1(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}

__device__ __forceinline__ float4 saxpy4(float a, float4 x, float4 y) {
  return make_float4(saxpy1(a, x.x, y.x), saxpy1(a, x.y, y.y), saxpy1(a, x.z, y.z),
                     saxpy1(a, x.w, y.w));
}

// o[0:len] = a x[0:len] + y[0:len] by the block's kSaxpyThreads threads, a
// pass of kSaxpyWork values at a time, neighbouring threads on
// neighbouring addresses.  VEC (x, y and o share their 16-byte phase, which
// the launch checks): a float4 of each input a thread from the first
// 16-byte boundary, then the scalar head before it and the tail after the
// last float4.  Else 4 values a thread, all 8 loads issued before the first
// store, so as many bytes stay in flight.
template <bool VEC>
__device__ __forceinline__ void saxpy_range(float a, const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            float* __restrict__ o, int len) {
  const int t = threadIdx.x;
  if constexpr (VEC) {
    const int head = min(len, int((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / 4);
    const int n4 = (len - head) / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x + head);
    const float4* y4 = reinterpret_cast<const float4*>(y + head);
    float4* o4 = reinterpret_cast<float4*>(o + head);
    for (int k = t; k < n4; k += kSaxpyThreads) o4[k] = saxpy4(a, x4[k], y4[k]);
    const int tail = head + 4 * n4;
    if (t < head) o[t] = saxpy1(a, x[t], y[t]);
    if (tail + t < len) o[tail + t] = saxpy1(a, x[tail + t], y[tail + t]);
  } else {
    for (int k0 = t; k0 < len; k0 += kSaxpyWork) {
      float xv[4], yv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * kSaxpyThreads;
        if (k < len) {
          xv[j] = x[k];
          yv[j] = y[k];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j * kSaxpyThreads;
        if (k < len) o[k] = saxpy1(a, xv[j], yv[j]);
      }
    }
  }
}

// K15.1 where x[0:n] fills no more than one wave of the card's threads
// (kSaxpyWave): one value a thread, the shortest chain from launch to
// store, which there sets the time.  The index is 64-bit: from a 32-bit
// one nvcc forms the addresses against pointers fetched by LDC, ahead of
// the first load.
__global__ void __launch_bounds__(kSaxpyThreads)
    tut_saxpy_wave_kernel(float a, const float* __restrict__ x, const float* __restrict__ y,
                          float* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * kSaxpyThreads + threadIdx.x;
  if (i < n) o[i] = saxpy1(a, x[i], y[i]);
}

// K15.1 beyond one wave: block b takes the range [b w, (b + 1) w) of
// x[0:n].
template <bool VEC>
__global__ void __launch_bounds__(kSaxpyThreads)
    tut_saxpy_flat_kernel(float a, const float* __restrict__ x, const float* __restrict__ y,
                          float* __restrict__ o, long long n, int w) {
  const long long begin = (long long)blockIdx.x * w;
  saxpy_range<VEC>(a, x + begin, y + begin, o + begin, int(n - begin < w ? n - begin : w));
}

// K15.2, K15.3: block (j, i) takes piece j of tile i, the tiles `rows`
// rows of an (ny, nx) array, each one range of rows nx values cut into
// pieces of at most w values (consecutive blocks, consecutive memory); `a`
// by value (K15.2), or with A_ON_DEVICE read from a_dev (K15.3).
template <bool A_ON_DEVICE, bool VEC>
__global__ void __launch_bounds__(kSaxpyThreads)
    tut_saxpy_rows_kernel(float a, const float* __restrict__ a_dev,
                          const float* __restrict__ x, const float* __restrict__ y,
                          float* __restrict__ o, int ny, int nx, int rows, int w) {
  if constexpr (A_ON_DEVICE) a = *a_dev;
  const int row0 = blockIdx.y * rows, first = blockIdx.x * w;
  const long long begin = (long long)row0 * nx + first;
  const int len = min(rows, ny - row0) * nx - first;
  saxpy_range<VEC>(a, x + begin, y + begin, o + begin, min(len, w));
}

// True where x, y and o share their 16-byte phase (a whole number of
// floats into it): the vector path.
inline bool saxpy_vec(const float* x, const float* y, const float* o) {
  const uintptr_t phase = reinterpret_cast<uintptr_t>(x) & 15;
  return phase % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == phase &&
         (reinterpret_cast<uintptr_t>(o) & 15) == phase;
}

// Values a block of K15.1-K15.3 takes: one pass of its threads
// (kSaxpyWork), fewer where that would leave under kSaxpyFillBlocks
// blocks, down to a warp's float4s.
inline int saxpy_block_values(long long n) {
  const long long w = ((n - 1) / kSaxpyFillBlocks / 128 + 1) * 128;
  return int(w < kSaxpyWork ? w : kSaxpyWork);
}

int saxpy_flat(float a, const float* x, const float* y, float* o, long long n,
               cudaStream_t stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  if (n <= kSaxpyWave) {
    tut_saxpy_wave_kernel<<<unsigned((n - 1) / kSaxpyThreads + 1), kSaxpyThreads, 0, stream>>>(
        a, x, y, o, n);
    return int(cudaGetLastError());
  }
  const int w = saxpy_block_values(n);
  const long long blocks = (n - 1) / w + 1;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  if (saxpy_vec(x, y, o))
    tut_saxpy_flat_kernel<true><<<unsigned(blocks), kSaxpyThreads, 0, stream>>>(a, x, y, o, n, w);
  else
    tut_saxpy_flat_kernel<false><<<unsigned(blocks), kSaxpyThreads, 0, stream>>>(a, x, y, o, n,
                                                                                  w);
  return int(cudaGetLastError());
}

// K15.2/K15.3 of an (ny, nx) array: tiles of as many rows as a block takes
// (at least one, and more where there would be over 65535 tiles, the
// grid's y limit), each cut into pieces of a block's values.
template <bool A_ON_DEVICE>
int saxpy_rows(float a, const float* a_dev, const float* x, const float* y, float* o, int ny,
               int nx, cudaStream_t stream) {
  if (ny < 1 || nx < 1) return int(cudaErrorInvalidValue);
  const int w = saxpy_block_values((long long)ny * nx);
  const int fit = (ny - 1) / 65535 + 1;
  const int rows = w / nx > fit ? w / nx : fit;
  const long long tile = (long long)rows * nx;
  if (tile > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const dim3 grid(unsigned((tile - 1) / w + 1), (ny - 1) / rows + 1);
  if (saxpy_vec(x, y, o))
    tut_saxpy_rows_kernel<A_ON_DEVICE, true><<<grid, kSaxpyThreads, 0, stream>>>(
        a, a_dev, x, y, o, ny, nx, rows, w);
  else
    tut_saxpy_rows_kernel<A_ON_DEVICE, false><<<grid, kSaxpyThreads, 0, stream>>>(
        a, a_dev, x, y, o, ny, nx, rows, w);
  return int(cudaGetLastError());
}

// K15.4, K15.6: block partials, then a one-block finish -------------------

// min and max that keep a NaN from either side
__device__ __forceinline__ float tut_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float tut_max(float a, float b) { return (b > a || b != b) ? b : a; }

struct SumAcc {
  float s;
  __device__ __forceinline__ void add(float v) { s = __fadd_rn(s, v); }
  __device__ __forceinline__ void merge(const SumAcc& b) { s = __fadd_rn(s, b.s); }
  static __device__ __forceinline__ SumAcc identity() { return SumAcc{0.0f}; }
  __device__ __forceinline__ SumAcc shfl_down(int off) const {
    return SumAcc{__shfl_down_sync(0xffffffffu, s, off)};
  }
};

struct StatsAcc4 {
  float s, l1, mn, mx;
  __device__ __forceinline__ void add(float v) {
    s = __fadd_rn(s, v);
    l1 = __fadd_rn(l1, fabsf(v));
    mn = tut_min(mn, v);
    mx = tut_max(mx, v);
  }
  __device__ __forceinline__ void merge(const StatsAcc4& b) {
    s = __fadd_rn(s, b.s);
    l1 = __fadd_rn(l1, b.l1);
    mn = tut_min(mn, b.mn);
    mx = tut_max(mx, b.mx);
  }
  static __device__ __forceinline__ StatsAcc4 identity() {
    const float inf = __int_as_float(0x7f800000);
    return StatsAcc4{0.0f, 0.0f, inf, -inf};
  }
  __device__ __forceinline__ StatsAcc4 shfl_down(int off) const {
    return StatsAcc4{__shfl_down_sync(0xffffffffu, s, off),
                     __shfl_down_sync(0xffffffffu, l1, off),
                     __shfl_down_sync(0xffffffffu, mn, off),
                     __shfl_down_sync(0xffffffffu, mx, off)};
  }
};

// The block's accumulators merged into thread 0's, in a fixed order.
template <class Acc, int THREADS>
__device__ __forceinline__ Acc tut_block_reduce(Acc a) {
  __shared__ Acc red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a.merge(a.shfl_down(off));
  if (lane == 0) red[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < THREADS / 32 ? red[lane] : Acc::identity();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a.merge(a.shfl_down(off));
  }
  return a;
}

__device__ __forceinline__ void store_acc(float* out, const SumAcc& a) { out[0] = a.s; }
__device__ __forceinline__ void store_acc(float* out, const StatsAcc4& a) {
  out[0] = a.s;
  out[1] = a.l1;
  out[2] = a.mn;
  out[3] = a.mx;
}
__device__ __forceinline__ SumAcc load_acc(const float* p, SumAcc) { return SumAcc{p[0]}; }
__device__ __forceinline__ StatsAcc4 load_acc(const float* p, StatsAcc4) {
  return StatsAcc4{p[0], p[1], p[2], p[3]};
}

// One partial of WIDTH floats per block over a grid-stride pass of x[0:n].
template <class Acc, int WIDTH>
__global__ void __launch_bounds__(kTutThreads)
    tut_partials_kernel(const float* __restrict__ x, long long n, float* __restrict__ partials) {
  Acc a = Acc::identity();
  const long long stride = (long long)gridDim.x * kTutThreads;
  const long long first = (long long)blockIdx.x * kTutThreads + threadIdx.x;
  long long tail = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long k = first; k < n4; k += stride) {
      const float4 v = x4[k];
      a.add(v.x);
      a.add(v.y);
      a.add(v.z);
      a.add(v.w);
    }
    tail = 4 * n4;
  }
  for (long long k = tail + first; k < n; k += stride) a.add(x[k]);
  a = tut_block_reduce<Acc, kTutThreads>(a);
  if (threadIdx.x == 0) store_acc(partials + (long long)blockIdx.x * WIDTH, a);
}

// out[0:WIDTH] = the partials of `blocks` blocks merged in a fixed tree.
template <class Acc, int WIDTH>
__global__ void __launch_bounds__(kTutFinishThreads)
    tut_finish_kernel(const float* __restrict__ partials, int blocks, float* __restrict__ out) {
  Acc a = Acc::identity();
  for (int k = threadIdx.x; k < blocks; k += kTutFinishThreads)
    a.merge(load_acc(partials + (long long)k * WIDTH, Acc{}));
  a = tut_block_reduce<Acc, kTutFinishThreads>(a);
  if (threadIdx.x == 0) store_acc(out, a);
}

inline int tut_reduce_blocks(long long n) {
  const long long per_block = 4LL * kTutThreads;
  const long long b = (n + per_block - 1) / per_block;
  return int(b < kTutMaxBlocks ? (b < 1 ? 1 : b) : kTutMaxBlocks);
}

template <class Acc, int WIDTH>
int tut_reduce(const float* x, long long n, float* partials, float* out, cudaStream_t stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  const int blocks = tut_reduce_blocks(n);
  tut_partials_kernel<Acc, WIDTH><<<blocks, kTutThreads, 0, stream>>>(x, n, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  tut_finish_kernel<Acc, WIDTH><<<1, kTutFinishThreads, 0, stream>>>(partials, blocks, out);
  return int(cudaGetLastError());
}

// K15.5 ----------------------------------------------------------------

// A (kLapTile + 2)^2 tile of x, its load index clamped to the grid (the
// edge replication), then N + S + E + W - 4 c per output cell.  Blocks of
// kLapTile x (kLapTile / kLapRowsPerThread) threads.
__global__ void __launch_bounds__(kLapTile * kLapTile / kLapRowsPerThread)
    tut_laplacian_kernel(const float* __restrict__ x, float* __restrict__ o, int ny, int nx) {
  __shared__ float tile[kLapTile + 2][kLapTile + 3];  // +1 column against bank conflicts
  const int y0 = blockIdx.y * kLapTile, x0 = blockIdx.x * kLapTile;
  const int tid = threadIdx.y * kLapTile + threadIdx.x;
  constexpr int kThreads = kLapTile * kLapTile / kLapRowsPerThread;
  constexpr int kSide = kLapTile + 2;
  for (int k = tid; k < kSide * kSide; k += kThreads) {
    const int ty = k / kSide, tx = k % kSide;
    const int gy = min(max(y0 + ty - 1, 0), ny - 1);
    const int gx = min(max(x0 + tx - 1, 0), nx - 1);
    tile[ty][tx] = x[(long long)gy * nx + gx];
  }
  __syncthreads();
  const int lx = threadIdx.x, gx = x0 + lx;
  if (gx >= nx) return;
#pragma unroll
  for (int r = 0; r < kLapRowsPerThread; ++r) {
    const int ly = threadIdx.y + r * (kLapTile / kLapRowsPerThread), gy = y0 + ly;
    if (gy >= ny) break;
    const float c = tile[ly + 1][lx + 1];
    const float north = tile[ly + 2][lx + 1];  // the row below in memory
    const float south = tile[ly][lx + 1];
    const float east = tile[ly + 1][lx + 2];
    const float west = tile[ly + 1][lx];
    const float sum = __fadd_rn(__fadd_rn(__fadd_rn(north, south), east), west);
    o[(long long)gy * nx + gx] = __fsub_rn(sum, __fmul_rn(4.0f, c));
  }
}

}  // namespace bt

extern "C" {

// K15.1: o[0:n] = a * x + y, float32, n >= 1.
int bt_tut_saxpy_whole(float a, const float* x, const float* y, float* o, long long n,
                       cudaStream_t stream) {
  return bt::saxpy_flat(a, x, y, o, n, stream);
}

// K15.2: o = a * x + y over (ny, nx) row-major float32 arrays.
int bt_tut_saxpy_rows(float a, const float* x, const float* y, float* o, int ny, int nx,
                      cudaStream_t stream) {
  return bt::saxpy_rows<false>(a, nullptr, x, y, o, ny, nx, stream);
}

// K15.3: the same with a = *a_dev, one float32 on the device.
int bt_tut_saxpy_rows_dev(const float* a_dev, const float* x, const float* y, float* o, int ny,
                          int nx, cudaStream_t stream) {
  return bt::saxpy_rows<true>(0.0f, a_dev, x, y, o, ny, nx, stream);
}

// The floats the partials buffer of K15.4 (width 1) or K15.6 (width 4)
// must hold for n values.
int bt_tut_num_partials(long long n, int width) { return bt::tut_reduce_blocks(n) * width; }

// K15.4: out[0] = sum of x[0:n], float32, n >= 1.
int bt_tut_block_sum(const float* x, long long n, float* partials, float* out,
                     cudaStream_t stream) {
  return bt::tut_reduce<bt::SumAcc, 1>(x, n, partials, out, stream);
}

// K15.6: out[0:4] = {sum x, sum |x|, min, max} of x[0:n], float32, n >= 1.
int bt_tut_fused_stats(const float* x, long long n, float* partials, float* out,
                       cudaStream_t stream) {
  return bt::tut_reduce<bt::StatsAcc4, bt::kTutStats>(x, n, partials, out, stream);
}

// K15.5: o = N + S + E + W - 4 c of an (ny, nx) float32 array, edges
// replicated.
int bt_tut_laplacian(const float* x, float* o, int ny, int nx, cudaStream_t stream) {
  if (ny < 1 || nx < 1) return int(cudaErrorInvalidValue);
  const dim3 grid((nx + bt::kLapTile - 1) / bt::kLapTile, (ny + bt::kLapTile - 1) / bt::kLapTile);
  if (grid.y > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 block(bt::kLapTile, bt::kLapTile / bt::kLapRowsPerThread);
  bt::tut_laplacian_kernel<<<grid, block, 0, stream>>>(x, o, ny, nx);
  return int(cudaGetLastError());
}

}  // extern "C"
