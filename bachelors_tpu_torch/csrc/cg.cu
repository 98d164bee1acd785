// Hand-written CUDA kernels for the conjugate-gradient loop of the
// semi-implicit solver, compiled for Hopper (sm_90a) and called through a
// plain C interface from bachelors_tpu_torch/ops/cuda_cg.py (ctypes).  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().  Scalars that the loop computes on the device
// (alpha, the dot products) are read through pointers, so the host never
// fetches them.  Each kernel is a template on the field type: entry points `bt_*_f32` run
// it at float32, `bt_*_f64` at float64.  The float64 semi-implicit step
// follows the JAX package's accelerator route (`bachelors_tpu/solvers/
// semi_implicit.py:_semi_implicit_step_dd` :234): a CG solve, the true
// residual of its result (K14), a second CG solve on that residual.  The
// TPU solves in float32 and takes the residual in float32 pairs because it
// has no float64 ALU; the H100 has one, so here both run in double.
//
// K8  bt_matvec_pAp: replaces `bachelors_tpu/ops/pallas_cg.py:_matvec_pAp`
//     (:49) with blend=False (entries `cross_matvec_pAp` :205 and
//     `aniso_matvec_pAp` :214).  Ap for the 5-point operator, either the
//     constant cross form C p + X (E+W) + Y (N+S) or the per-cell form
//     (1 + C s) p + X s (E+W) + Y s (N+S), and <p, Ap> from the same read of
//     p.  Ghosts take Dirichlet value 0: the CG vectors are deltas.  Bound
//     by bytes (1 or 2 fields read, 1 written, ~10 flops per cell).  Design:
//     one thread per cell, neighbours from device memory (L1/L2 catch the
//     stencil's reuse), a block sum of p Ap per 32x8 tile, and the dot
//     product finished in the same launch, in the order of the one-block
//     sum kernel it replaces: at most 1024 blocks, each adding its tiles'
//     sums into its lane of that kernel's 1024, and the block that finishes
//     last adding the lanes by that kernel's tree.  One launch per call:
//     the call's host time fell from 13.1 to 5.2 µs at 512^2, its device
//     time rose from 4.1 to 5.1 µs there (the last block's fence, ticket
//     and tree follow the last tile; H100 80GB HBM3, 700 W, PERF.md §6).
//     The output may be a dead buffer the caller passes in, never p (the
//     wrapper checks).
//
// K12.8 bt_matvec_pAp_halo: replaces `pallas_cg.py:
//     cross_matvec_pAp_sharded` (:238) and `aniso_matvec_pAp_sharded` (:249),
//     both `_matvec_pAp` with ghost rows and columns (`_ghost_kw` :223).  K8
//     itself with a Halo (physics.cuh): at a seam it reads p's ghost row or
//     column (the ghost gather of (p, p), as `_ghost_kw` sends it, exchanged
//     by the caller), at a global edge the image at value 0 (-p for
//     Dirichlet), or the ghost for a periodic field.  Its <p, Ap> is the
//     shard's own; the caller adds the shards' partials.  Each cell runs K8's
//     arithmetic on the values K8 reads, so the joined A p equals K8's bit for
//     bit; the dot adds in another order.  Bound by bytes like K8.
//
// K8b bt_advance_p_matvec: replaces `pallas_cg.py:_matvec_pAp` (:49) with
//     blend=True (entries `cross_advance_p_matvec` :258 and
//     `aniso_advance_p_matvec` :265), the direction update of
//     `cg_solve_fused` folded into K8: p' = r + beta p is formed at every
//     cell K8 reads (its own and its four neighbours, as JAX forms the blend
//     on its haloed tiles, :101-104), p' is written, and A p' and <p', A p'>
//     come out as K8's.  The edge image -v is linear, so the image of the
//     blend is the blend of the images.  beta is a device scalar, read
//     through a pointer.  At float the blend keeps its FMA; at double it is
//     rounded twice (`blend_of`), as the plain version's r + beta * p is.
//     Bound by bytes (r, p [, s] read, p' and A p' written).  Design: K8's
//     one thread per cell, the blend re-formed at each of the five reads
//     (L1 catches the reuse).  p' goes to its own buffer, never p or r,
//     whose neighbours other threads read; A p' may go over the dead Ap.
//     One device only: JAX raises for ghost columns with the blend (:72-74)
//     and no path wires ghost rows.
//
// K9  bt_update_xr_rr: replaces `pallas_cg.py:_update_xr_rr` (:310,
//     entry `update_xr_rr` :343).  x += alpha p and r -= alpha Ap in place,
//     and <r', r'> of the new r: block partials, then the one-block sum.
//     Pointwise, so in place is safe.  Bound by bytes (4 fields read, 2
//     written).
//
// K10 bt_advance_p: replaces `pallas_cg.py:_axpby_inplace` (:274, entry
//     `axpby_inplace` :300) as the CG loop calls it, a = 1 and b = beta:
//     p = r + beta p in place, with beta = rr_new / (rr < eps ? eps : rr)
//     formed in the kernel from the two dot products, device scalars read
//     through pointers, so the host runs no op between K9 and K10.  The
//     select keeps a NaN rr, as torch.clamp does (fmax would drop it, and
//     a NaN must never read as converged).  Every operation is rounded on
//     its own (`__f*_rn`, `__d*_rn`; cg.cu keeps FMA contraction), in the
//     plain version's order -- beta, then p * beta, then + r -- so K10
//     equals it bit for bit.  Bound by bytes (r and p read, p written):
//     16-byte loads and stores where both fields are 16-byte aligned, a
//     scalar tail.
//
// K14 bt_si_residual: replaces `bachelors_tpu/ops/pallas_dd.py:
//     _make_cross_residual_kernel` (:749, via `_cross_residual_call` :882;
//     entries `cross_residual_dd` :940, `aniso_residual_dd` :950,
//     `heat_residual_dd` :960).  The refinement residual r1 = r0 - A e of
//     the float64 semi-implicit step, A the constant cross operator (mode
//     0), the per-cell anisotropy operator with map s (mode 1), or in heat
//     mode the cross operator with r0 built in the kernel as
//     L (e1_F + e2_F) + uterm (mode 2) plus the corrector/gamma terms
//     (mode 3).  The TPU kernel carries r0 and the products in float32
//     pairs; here they are Real.  Ghosts take Dirichlet value 0, as K8's.
//     Bound by bytes (2-5 fields read, 1 written).  Design: K8's matvec,
//     one thread per cell, without the dot product.  The output must not
//     overlap e, whose neighbours it reads.
//
// K14 twin bt_si_residual_halo: replaces `pallas_dd.py:
//     cross_residual_dd_sharded` (:1014), `aniso_residual_dd_sharded` (:1027)
//     and `heat_residual_dd_sharded` (:1039), `_cross_residual_call` (:882)
//     with e's ghost rows and columns (`_ghost_rows_e` :976, `_ghost_cols_e`
//     :984).  K14 with a Halo, as K12.8 is K8 with one: at a seam it reads
//     e's ghost (the gather of (e, e), field 0), at a global edge the image
//     at value 0 (-e for Dirichlet, `_ghost_cols_e`'s sign), or the ghost
//     for a periodic field.  The other planes are pointwise.  Each cell runs
//     K14's arithmetic on the values K14 reads, so a mesh equals K14 on the
//     whole grid bit for bit.  Bound by bytes like K14.
//
// The partial sums are added in a fixed order, never by a library
// reduction: K9's by a second kernel (`sum_partials_kernel`), as K2's error
// maxima are; K8's, K12.8's and K8b's by their own last block in that
// kernel's exact order, so a K8 dot product has the bits it had as two
// launches.  Block sums run in a fixed tree order, so a result does not
// change from run to run; it differs from torch.sum's order by ~1e-7
// relative in float32 (~1e-16 in float64).
#include <cuda_runtime.h>

#include <cstdint>

#include "physics.cuh"

namespace bt {

constexpr int kCgBlockX = 32;
constexpr int kCgBlockY = 8;
constexpr int kCgThreads = kCgBlockX * kCgBlockY;
constexpr int kSumThreads = 1024;

// Sum of v over the block's threads (a multiple of 32), valid in thread 0.
// `red` holds one value per warp.
template <int THREADS, class Real>
__device__ __forceinline__ Real block_sum(Real v, Real* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < THREADS / 32 ? red[tid] : Real(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------- K8 ----

// A fence with acquire and release semantics at device scope: what the
// ticket protocol needs, and lighter than __threadfence()'s sequentially
// consistent one.  Before a relaxed atomic it releases this thread's writes
// to whoever reads the atomic's result; after one, it acquires what the
// writers released.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The tree of sum_partials_kernel's kSumThreads lane sums (block_sum
// <kSumThreads>: warp shuffles, then over the warps), lanes[0:n] and 0
// past them, by a kCgThreads block; valid in thread 0.  Thread t carries
// lanes t + q kCgThreads (q < 4), so warp w's shuffles of register q are
// lane-warp w + 8q's, and warp 0 finishes over the 32 lane-warp sums.  The
// other blocks' lanes are read past L1 (`__ldcg`).
template <class Real>
__device__ __forceinline__ Real lane_tree(const Real* lanes, int n, Real* red) {
  constexpr int kLanes = kSumThreads / kCgThreads;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const int L = tid + q * kCgThreads;
    Real v = L < n ? __ldcg(lanes + L) : Real(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) red[(tid >> 5) + q * (kCgThreads / 32)] = v;
  }
  __syncthreads();
  Real total = Real(0);
  if (tid < 32) {
    total = red[tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
  }
  return total;
}

// r + beta p: at float with its FMA, at double rounded at each operation,
// as the plain version's two tensor ops are.
__device__ __forceinline__ float blend_of(float r, float beta, float p) { return r + beta * p; }
__device__ __forceinline__ double blend_of(double r, double beta, double p) {
  return __dadd_rn(r, __dmul_rn(beta, p));
}

// `cross_at`'s reader of K8b's direction p' = r + beta p, formed at each read.
template <class Real>
struct BlendLoad {
  const Real* r;
  const Real* p;
  Real beta;
  __device__ __forceinline__ Real operator()(int idx) const {
    return blend_of(r[idx], beta, p[idx]);
  }
};

// K8 on the whole grid (h = whole_grid) or, with a halo (field 0 of its
// ghosts is p's), K12.8 on a shard; the partials then sum the shard's own
// cells only.  BLEND: K8b, which reads p' = r + *beta p through `BlendLoad`
// and writes it to p_out (whole grid only).
//
// <p, Ap> in the order of the one-block sum launch this kernel replaces:
// the field's kCgBlockY x kCgBlockX tiles, row-major, each summed by
// block_sum into a partial; lane L of kSumThreads adding partials L, L +
// kSumThreads, ... from 0; then the lanes' tree.  The grid is min(tiles,
// kSumThreads) blocks and block b takes tiles b, b + kSumThreads, ...: lane
// b's partials, in its order, so thread 0 adds them into lane b as they
// come and writes only the lane.  Then it draws a ticket; the block that
// draws the last one adds the lanes by the tree into *pAp.  `atomicInc`
// wraps the ticket counter back to 0 with that last draw, so a counter
// zeroed once serves every launch on its stream.
template <bool WITH_S, bool BLEND, class Real>
__global__ void __launch_bounds__(kCgThreads)
    matvec_pAp_kernel(const Real* __restrict__ p, const Real* __restrict__ s,
                      const Real* __restrict__ r, const Real* __restrict__ beta,
                      Real* __restrict__ p_out, Real* __restrict__ out, Real* lanes,
                      unsigned* ticket, Real* __restrict__ pAp_out, int ny, int nx,
                      int tiles_x, int tiles, int bc, Real C, Real X, Real Y, Halo<Real> h) {
  __shared__ Real red[kSumThreads / 32];  // two tiles' warp sums in turns, then the tree's
  __shared__ bool last;
  Real lane = Real(0);  // in thread 0
  int half = 0;
  for (int t = blockIdx.x; t < tiles; t += kSumThreads, half ^= kCgThreads / 32) {
    const int j = (t % tiles_x) * kCgBlockX + threadIdx.x;
    const int i = (t / tiles_x) * kCgBlockY + threadIdx.y;
    Real pAp = Real(0);
    if (i < ny && j < nx) {
      const int c = i * nx + j;
      Real pc;
      Cross<Real> n;
      if (BLEND) {
        const BlendLoad<Real> at{r, p, *beta};
        pc = at(c);
        n = cross_at(at, bc, 0, pc, Real(0), h, i, j, ny, nx);
        p_out[c] = pc;
      } else {
        pc = p[c];
        n = cross_at(Load<Real>{p}, bc, 0, pc, Real(0), h, i, j, ny, nx);
      }
      Real Av;
      if (WITH_S) {
        const Real sv = s[c];
        Av = (Real(1) + C * sv) * pc + (X * sv) * (n.E + n.W) + (Y * sv) * (n.N + n.S);
      } else {
        Av = C * pc + X * (n.E + n.W) + Y * (n.N + n.S);
      }
      out[c] = Av;
      pAp = pc * Av;
    }
    lane += block_sum<kCgThreads>(pAp, red + half);
  }
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    lanes[blockIdx.x] = lane;
    fence_acq_rel_gpu();  // releases the lane with the ticket
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    if (last) fence_acq_rel_gpu();  // acquires every block's lane
  }
  __syncthreads();
  if (last) {
    const Real sum = lane_tree(lanes, int(gridDim.x), red);
    if (threadIdx.x == 0 && threadIdx.y == 0) *pAp_out = sum;
  }
}

// ---------------------------------------------------------------- K9 ----

template <class Real>
__global__ void __launch_bounds__(kCgThreads)
    update_xr_rr_kernel(Real* __restrict__ x, Real* __restrict__ r,
                        const Real* __restrict__ p, const Real* __restrict__ Ap,
                        const Real* __restrict__ alpha, Real* __restrict__ partials,
                        int n) {
  __shared__ Real red[kCgThreads / 32];
  const int c = blockIdx.x * kCgThreads + threadIdx.x;
  Real rr = Real(0);
  if (c < n) {
    const Real a = *alpha;
    x[c] = x[c] + a * p[c];
    const Real rn = r[c] - a * Ap[c];
    r[c] = rn;
    rr = rn * rn;
  }
  const Real total = block_sum<kCgThreads>(rr, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// --------------------------------------------------------------- K10 ----

// Each operation rounded on its own: cg.cu is built with FMA contraction.
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// W values of 16 bytes, loaded and stored at once
template <class Real, int W>
struct alignas(sizeof(Real) * W) Pack {
  Real v[W];
};

// p[c] = r[c] + beta p[c] for W cells per thread (W = 1: one cell)
template <int W, class Real>
__global__ void __launch_bounds__(kCgThreads)
    advance_p_kernel(const Real* __restrict__ r, Real* __restrict__ p,
                     const Real* __restrict__ rr_new, const Real* __restrict__ rr, Real eps,
                     int n) {
  const Real den = *rr < eps ? eps : *rr;  // a NaN rr stays NaN
  const Real beta = div_rn(*rr_new, den);
  const int c = (blockIdx.x * kCgThreads + threadIdx.x) * W;
  if (c + W <= n) {
    Pack<Real, W> rv = *reinterpret_cast<const Pack<Real, W>*>(r + c);
    Pack<Real, W> pv = *reinterpret_cast<const Pack<Real, W>*>(p + c);
#pragma unroll
    for (int k = 0; k < W; ++k) pv.v[k] = add_rn(mul_rn(pv.v[k], beta), rv.v[k]);
    *reinterpret_cast<Pack<Real, W>*>(p + c) = pv;
  } else {
    for (int k = c; k < n; ++k) p[k] = add_rn(mul_rn(p[k], beta), r[k]);
  }
}

// --------------------------------------------------------------- K14 ----

constexpr int kResCross = 0;
constexpr int kResAniso = 1;
constexpr int kResHeat = 2;
constexpr int kResHeatExtra = 3;

// a: the map s (aniso) or e1_F (heat); b: e2_F (heat); x: the extra heat
// terms (heat + extra)
// On the whole grid (h = whole_grid) or, with a halo (field 0 of its ghosts
// is e's), the K14 twin on a shard.
template <int MODE, class Real>
__global__ void __launch_bounds__(kCgThreads)
    si_residual_kernel(const Real* __restrict__ e, const Real* __restrict__ r0,
                       const Real* __restrict__ a, const Real* __restrict__ b,
                       const Real* __restrict__ x, Real* __restrict__ out, int ny, int nx,
                       int bc, Real C, Real X, Real Y, Real L, Halo<Real> h) {
  const int j = blockIdx.x * kCgBlockX + threadIdx.x;
  const int i = blockIdx.y * kCgBlockY + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int c = i * nx + j;
  const Real ec = e[c];
  const Cross<Real> n = cross_at(Load<Real>{e}, bc, 0, ec, Real(0), h, i, j, ny, nx);
  Real Ae;
  if (MODE == kResAniso) {
    const Real sv = a[c];
    Ae = (Real(1) + C * sv) * ec + (X * sv) * (n.E + n.W) + (Y * sv) * (n.N + n.S);
  } else {
    Ae = C * ec + X * (n.E + n.W) + Y * (n.N + n.S);
  }
  Real r = r0[c];
  if (MODE >= kResHeat) r = L * (a[c] + b[c]) + r;
  if (MODE == kResHeatExtra) r = r + x[c];
  out[c] = r - Ae;
}

// ------------------------------------------------------- partial sums ----

// out[0] = sum of partials[0:n], in one block and a fixed order.
template <class Real>
__global__ void __launch_bounds__(kSumThreads)
    sum_partials_kernel(const Real* __restrict__ partials, int n, Real* __restrict__ out) {
  __shared__ Real red[kSumThreads / 32];
  Real v = Real(0);
  for (int k = threadIdx.x; k < n; k += kSumThreads) v += partials[k];
  const Real total = block_sum<kSumThreads>(v, red);
  if (threadIdx.x == 0) out[0] = total;
}

inline dim3 matvec_grid(int ny, int nx) {
  return dim3((nx + kCgBlockX - 1) / kCgBlockX, (ny + kCgBlockY - 1) / kCgBlockY);
}

inline int pointwise_blocks(int n) { return (n + kCgThreads - 1) / kCgThreads; }

// Partials K9 writes (and K8's at most kSumThreads lanes) for a (ny, nx)
// field; K8's ticket counter sits in the slot after them
// (`bt_cg_num_partials` counts it).
inline int cg_partials(int ny, int nx) {
  dim3 g = matvec_grid(ny, nx);
  int a = int(g.x * g.y), b = pointwise_blocks(ny * nx);
  return a > b ? a : b;
}

// K8 (r null) or K8b (r, beta and p_out given): out = A p (or A p', p_out
// = p'), *pAp = the dot product; its lanes and ticket in `partials`.
template <class Real>
int matvec_pAp(const Real* p, const Real* s, const Real* r, const Real* beta, Real* p_out,
               Real* out, Real* partials, Real* pAp, int ny, int nx, int bc, Real C, Real X,
               Real Y, Halo<Real> h, cudaStream_t stream) {
  const dim3 g = matvec_grid(ny, nx);
  const int tiles = int(g.x * g.y);
  const dim3 grid(tiles < kSumThreads ? tiles : kSumThreads), block(kCgBlockX, kCgBlockY);
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + cg_partials(ny, nx));
#define BT_MATVEC(WS, BL)                                                                    \
  matvec_pAp_kernel<WS, BL><<<grid, block, 0, stream>>>(p, s, r, beta, p_out, out, partials, \
                                                        ticket, pAp, ny, nx, int(g.x), tiles, \
                                                        bc, C, X, Y, h)
  if (r != nullptr) {
    if (s != nullptr)
      BT_MATVEC(true, true);
    else
      BT_MATVEC(false, true);
  } else if (s != nullptr) {
    BT_MATVEC(true, false);
  } else {
    BT_MATVEC(false, false);
  }
#undef BT_MATVEC
  return int(cudaGetLastError());
}

template <class Real>
int update_xr_rr(Real* x, Real* r, const Real* p, const Real* Ap, const Real* alpha,
                 Real* partials, Real* rr, int n, cudaStream_t stream) {
  int blocks = pointwise_blocks(n);
  update_xr_rr_kernel<<<blocks, kCgThreads, 0, stream>>>(x, r, p, Ap, alpha, partials, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(static_cast<const Real*>(partials),
                                                     blocks, rr);
  return int(cudaGetLastError());
}

template <class Real>
int advance_p(const Real* r, Real* p, const Real* rr_new, const Real* rr, Real eps, int n,
              cudaStream_t stream) {
  constexpr int W = 16 / int(sizeof(Real));
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(p)) % 16 == 0)
    advance_p_kernel<W><<<pointwise_blocks((n + W - 1) / W), kCgThreads, 0, stream>>>(
        r, p, rr_new, rr, eps, n);
  else
    advance_p_kernel<1><<<pointwise_blocks(n), kCgThreads, 0, stream>>>(r, p, rr_new, rr,
                                                                         eps, n);
  return int(cudaGetLastError());
}

template <class Real>
int si_residual(const Real* e, const Real* r0, const Real* a, const Real* b, const Real* x,
                Real* out, int ny, int nx, int bc, int mode, Real C, Real X, Real Y, Real L,
                Halo<Real> h, cudaStream_t stream) {
  dim3 grid = matvec_grid(ny, nx);
  dim3 block(kCgBlockX, kCgBlockY);
  switch (mode) {
    case kResCross:
      si_residual_kernel<kResCross><<<grid, block, 0, stream>>>(e, r0, a, b, x, out, ny, nx, bc, C, X, Y, L, h);
      break;
    case kResAniso:
      si_residual_kernel<kResAniso><<<grid, block, 0, stream>>>(e, r0, a, b, x, out, ny, nx, bc, C, X, Y, L, h);
      break;
    case kResHeat:
      si_residual_kernel<kResHeat><<<grid, block, 0, stream>>>(e, r0, a, b, x, out, ny, nx, bc, C, X, Y, L, h);
      break;
    case kResHeatExtra:
      si_residual_kernel<kResHeatExtra><<<grid, block, 0, stream>>>(e, r0, a, b, x, out, ny, nx, bc, C, X, Y, L, h);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace bt

// The C interface: `bt_*_f32` on float32 fields and scalars, `bt_*_f64` on
// float64 ones (SFX, type S).
//   K8 bt_matvec_pAp: out = A p and pAp[0] = <p, A p>.  s null: the cross
//      operator C p + X (E+W) + Y (N+S); s given: (1 + C s) p + X s (E+W) +
//      Y s (N+S).  bc: the field's BoundaryType (0 periodic, 1 Neumann, 2
//      Dirichlet at 0).  out must not overlap p.  partials holds
//      bt_cg_num_partials values, its ticket counter zeroed before the
//      first launch; launches that share it run on one stream.
//   K8b bt_advance_p_matvec: p_out = p' = r + beta[0] p, out = A p' and
//      pAp[0] = <p', A p'>, A as for K8.  p_out and out overlap none of r,
//      p, s and each other.
//   K9 bt_update_xr_rr: x += alpha p, r -= alpha Ap (in place, n cells),
//      rr[0] = <r, r>.
//   K10 bt_advance_p: p = r + beta p in place (n cells), beta = rr_new[0] /
//      (rr[0] < eps ? eps : rr[0]); rr_new and rr are device scalars.
//   K14 bt_si_residual: out = r0 - A e for mode 0 (cross: C e + X (E+W) +
//      Y (N+S)) and 1 (aniso with map a: (1 + C a) e + X a (E+W) + Y a
//      (N+S)); modes 2 and 3 take r0 := L (a + b) + r0 [+ x] first, with
//      the cross operator.  Pointers a mode does not read may be null.
//      out must not overlap e.
//   K12.8 bt_matvec_pAp_halo and the K14 twin bt_si_residual_halo: K8 and
//      K14 on a shard of a mesh.  `rows`/`cols` are the ghosts of p (of e),
//      (2 sides, 2 fields, nx) and (2, 2, ny) with p (e) in field 0, null
//      along an axis that is not sharded; `edges` has bit 0..3 set when the
//      shard holds the grid's first row, last row, first column, last
//      column.  pAp[0] = the shard's own <p, A p>.
#define BT_CG_ENTRIES(SFX, S)                                                         \
  int bt_matvec_pAp_##SFX(const S* p, const S* s, S* out, S* partials, S* pAp,       \
                          int ny, int nx, int bc, S C, S X, S Y, cudaStream_t stream) { \
    return bt::matvec_pAp<S>(p, s, nullptr, nullptr, nullptr, out, partials, pAp, ny, nx, \
                             bc, C, X, Y, bt::whole_grid<S>(), stream);               \
  }                                                                                   \
  int bt_advance_p_matvec_##SFX(const S* r, const S* p, const S* s, const S* beta,   \
                                S* p_out, S* out, S* partials, S* pAp, int ny, int nx, \
                                int bc, S C, S X, S Y, cudaStream_t stream) {         \
    return bt::matvec_pAp<S>(p, s, r, beta, p_out, out, partials, pAp, ny, nx, bc, C, \
                             X, Y, bt::whole_grid<S>(), stream);                      \
  }                                                                                   \
  int bt_update_xr_rr_##SFX(S* x, S* r, const S* p, const S* Ap, const S* alpha,     \
                            S* partials, S* rr, int n, cudaStream_t stream) {         \
    return bt::update_xr_rr<S>(x, r, p, Ap, alpha, partials, rr, n, stream);         \
  }                                                                                   \
  int bt_advance_p_##SFX(const S* r, S* p, const S* rr_new, const S* rr, S eps, int n, \
                         cudaStream_t stream) {                                       \
    return bt::advance_p<S>(r, p, rr_new, rr, eps, n, stream);                       \
  }                                                                                   \
  int bt_si_residual_##SFX(const S* e, const S* r0, const S* a, const S* b,          \
                           const S* x, S* out, int ny, int nx, int bc, int mode,      \
                           S C, S X, S Y, S L, cudaStream_t stream) {                 \
    return bt::si_residual<S>(e, r0, a, b, x, out, ny, nx, bc, mode, C, X, Y, L,     \
                              bt::whole_grid<S>(), stream);                           \
  }                                                                                   \
  int bt_matvec_pAp_halo_##SFX(const S* p, const S* s, S* out, S* partials, S* pAp,  \
                               int ny, int nx, int bc, S C, S X, S Y, const S* rows,  \
                               const S* cols, int edges, cudaStream_t stream) {       \
    return bt::matvec_pAp<S>(p, s, nullptr, nullptr, nullptr, out, partials, pAp, ny, nx, \
                             bc, C, X, Y, bt::Halo<S>{rows, cols, edges}, stream);    \
  }                                                                                   \
  int bt_si_residual_halo_##SFX(const S* e, const S* r0, const S* a, const S* b,     \
                                const S* x, S* out, int ny, int nx, int bc, int mode, \
                                S C, S X, S Y, S L, const S* rows, const S* cols,     \
                                int edges, cudaStream_t stream) {                     \
    return bt::si_residual<S>(e, r0, a, b, x, out, ny, nx, bc, mode, C, X, Y, L,     \
                              bt::Halo<S>{rows, cols, edges}, stream);                \
  }

extern "C" {

// Values the partials buffer of K8 and K9 must hold for a (ny, nx) field:
// their partials, then one slot whose first 4 bytes are K8's ticket
// counter, which must be zeroed once, when the buffer is allocated.
int bt_cg_num_partials(int ny, int nx) { return bt::cg_partials(ny, nx) + 1; }

BT_CG_ENTRIES(f32, float)
BT_CG_ENTRIES(f64, double)

}  // extern "C"
