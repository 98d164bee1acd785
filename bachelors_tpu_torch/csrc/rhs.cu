// Hand-written CUDA kernels for the Allen-Cahn + heat right-hand side,
// compiled for Hopper (sm_90a) and called through a plain C interface from
// bachelors_tpu_torch/ops/cuda_rhs.py (ctypes).  Every entry point launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().
// Each kernel is a template on the arithmetic type (physics.cuh): entry
// points `bt_*_f32` run it on float32 fields, `bt_*_f64` on float64 fields
// (see "Float64" below).
//
// K1  bt_blend_rhs: replaces `bachelors_tpu/ops/pallas_rhs.py:_make_kernel`
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
// K4  bt_rk4_final_f32: replaces `_make_kernel` in mode "rk4_combine"
//     (:433-440, entry `rk4_final_stage_pallas` :1359): k4 = f(x + dt k3)
//     and x + dt/6 (k1 + 2 k2 + 2 k3 + k4) in one pass; k4 is never stored.
//     Bound by bytes: it reads 8 fields and writes 2 (40 B per cell).
//     Design: K1's, one thread per cell; the blend [x, k3] is formed in
//     registers at the cell and its four neighbours (`blend_rhs_at`, shared
//     with K1) and the combination is done in the same thread.
//
// K2  bt_rkm_attempt_f32: replaces `_make_fullstep_kernel` (:941) with
//     scheme "rkm" (entry `rkm_attempt_pallas` :1163): one whole Merson
//     attempt -- stages k1..k5, the update x + tau/6 (k1 + 4 k4 + k5), and
//     per-field maxima of |0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|.
//     It reads 2 fields and writes 2 (the staged path moves ~4 fields per
//     stage), a byte floor of 0.020 ms at 2048^2; it measured 0.373 ms there
//     (H100 80GB HBM3, 700 W): bound by latency and by what it computes,
//     not by bytes -- ~60 flops per cell (and atan2f + cosf unless S = 0)
//     in each of 5 stages, on 1.42x the owned cells because of the
//     shrinking apron, all through shared memory.  Design: the apron tile
//     below with A = 5; shared memory holds x, k1, k2 (reused for k3), k4
//     and the current blend for both fields: 10 arrays of 42x26 values,
//     43.7 KB at float, 87.4 KB at double.  A tile whose region lies inside
//     the domain (a block-uniform test) evaluates its stages without edge
//     tests; at S = 0 the host launches the isotropic instantiation, which
//     skips atan2 and cos; at double with S != 0 a block has 512 threads
//     (two fit an SM), else 256 (`K2Block`, chosen by measurement).
//     Per-block error maxima go to a partials buffer (warp shuffles, then
//     one value per warp), reduced by a second one-block kernel; both keep
//     NaN.
//
// K3  bt_rk4_full_f32: replaces `_make_fullstep_kernel` (:941) with scheme
//     "rk4" (entry `rk4_full_pallas` :1156): one whole RK4 step,
//     x + dt/6 (k1 + 2 k2 + 2 k3 + k4).  It reads 2 fields and writes 2 (the
//     staged route moves 4, 6, 6 and 10 fields for its four launches).
//     Far from its byte floor (0.080 ms at 4096^2), like K2: 4 stages of
//     ~50 flops (and atan2f + cosf unless S = 0) per cell on 5.23x the
//     owned cells, through shared memory, with barriers between.  Design:
//     K2's tile with A = 4 and the RK4 tableau; shared memory holds x, k1,
//     k2 and k3 for both fields, 8 arrays of 40x24 values, 30.7 KB at float
//     and 61.4 KB at double (three blocks an SM); each stage forms its state
//     x + w k at its reads.  As K2, interior tiles skip the edge tests and
//     S = 0 takes the isotropic instantiation.  Measured at 4096^2 (H100
//     80GB HBM3, 700 W; device time a launch, PERF.md §6): 700 us at float32
//     S = 0.25 and 401 at S = 0, both 1112 before; 677 at double S = 0, 1407
//     before.
//
// K6  bt_euler_steps_f32: replaces `_make_euler2_kernel` (:797, entry
//     `euler2_pallas` :1272): T forward-Euler steps per pass over device
//     memory, a template parameter, built for the paths' depths: T = 4 at
//     float32, T = 4 and 8 at float64.  It reads 2 fields and writes 2 for
//     T steps, 16 B per cell.  Design: the apron tile below with A = T;
//     step s is evaluated on the tile grown by T - 1 - s cells into the
//     other of two buffers (4 arrays of (32 + 2T)x(16 + 2T) floats, 15.4 KB
//     at T = 4), so no intermediate step leaves the SM.  The JAX kernel
//     resets each field's ghost rows to its own boundary image before every
//     step; here the boundary rule below applies at every step instead.
//
// K7  bt_si_prepare_f32: replaces `_make_kernel` in mode "si_prepare"
//     (`_make_si_terms` :292, entry `si_prepare_pallas` :612): the
//     delta-form semi-implicit prepare.  One pass over (F, U) writes the
//     phase residual r0_F = b_F - A_F Phi, the heat term uterm = dt lap(U)
//     and, only when the anisotropy map varies per cell (S != 0 or the
//     corrector guess, `si_s_varies` :283), the map s itself.  Bound by
//     bytes: 2 fields read, 2 or 3 written, one atan2f + cosf per cell.
//     Design: K1's, one thread per cell with neighbours from device memory;
//     the arithmetic is the plain version's
//     (models/allen_cahn.py:semi_implicit_prepare + solvers/
//     semi_implicit.py:_lap_from_padded), not the TPU kernel's square-cell
//     fold, so the two round alike.  Ghosts take Dirichlet value 0, as the
//     JAX package's prepare does.
//
// K5  bt_rkm_final: replaces `_make_kernel` in mode "rkm_final" (:441,
//     entry `rkm_final_stage_pallas` :1373; on a mesh
//     `rkm_final_stage_pallas_sharded` :767): k5 = f(x + tau/2 k1 - 3tau/2 k3
//     + 2tau k4), x + tau/6 (k1 + 4 k4 + k5) and the per-block maxima of
//     |0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|, reduced as K2's.  Bound by bytes:
//     it reads 8 fields and writes 2.  Design: K1's, one thread per cell,
//     k5 in registers (never stored); the block's maxima through shared
//     memory.  On one device no path launches it (K2 takes every grid); the
//     x and 2D meshes do, with ghosts.
//
// K12.1 bt_blend_rhs_halo and bt_halo_edges: replaces
//     `_stage_call_sharded` (:705) -> `_call` (:539) with ghost rows and
//     columns, and the edge blends of `_ghost_rows` (:634) / `_ghost_cols`
//     (:672).  K1 on a shard, reading a Halo (physics.cuh) at seams: the blend of
//     the neighbour's edge row or column, gathered by one launch of
//     halo_edges per shard and stage (both fields, rows and columns; the
//     strided columns never go through a torch copy) and exchanged by tensor
//     copies.  Bound by bytes like K1; the gather moves 2 rows or columns.
//
// K12.2 bt_rkm_attempt_slabs_f32: replaces `_fullstep_call_sharded` (:1185,
//     via `rkm_attempt_pallas_sharded` :1245).  K2's kernel itself, its
//     apron rows beyond a y-mesh shard loaded from the neighbours' ghost
//     slabs (an `Apron` of ghost rows only: 5 rows, K2's apron; JAX's 8 are
//     Mosaic's sublane padding) and its edge test on global rows, so the
//     boundary image applies only at true domain edges and every cell runs
//     K2's arithmetic: a y-mesh equals K2 on the whole grid bit for bit.
//
// K12.3 bt_blend_rhs_halo with is_euler: replaces
//     `blend_rhs_pallas_sharded` (:744) with is_euler=True, through
//     `_stage_call_sharded` (:705): K12.1 in K1's euler mode, x + dt f(x) on a
//     shard from the ghosts of x.  Bound by bytes like K1 (2 fields read, 2
//     written).
//
// K12.4 bt_rk4_final_halo: replaces `rk4_final_stage_pallas_sharded`
//     (:756): K4 with a Halo, the ghosts those of the blend [x, k3] at weights
//     [1, dt] from the same gather.  Bound by bytes like K4 (8 fields read, 2
//     written).
//
// K12.5 bt_euler_steps_slabs_f32: replaces `_euler2_call_sharded` (:1315, via
//     `euler2_pallas_sharded` :1346; slabs `_ghost_slabs` :897, edge flags
//     `_edge_flags` :1222).  K6's kernel itself with K12.2's loader: T = 4
//     Euler steps per pass on a y-mesh shard from ghost slabs T rows deep
//     (JAX's 8 are sublane padding), the boundary image at global rows only.
//     A y-mesh runs K6's arithmetic per cell, so it equals K6 on the whole
//     grid bit for bit.  Bound like K6.
//
// K12.6 bt_rk4_full_slabs_f32: replaces `rk4_full_pallas_sharded` (:1231,
//     through `_fullstep_call_sharded` :1185 with scheme rk4).  K3's kernel
//     with the same loader, slabs 4 rows deep (K3's apron): a y-mesh equals
//     K3 on the whole grid bit for bit.  Bound like K3.
//
// K12.7 bt_si_prepare_halo: replaces `si_prepare_pallas_sharded` (:625,
//     through `_stage_call_sharded` :705 -> `_call` :539 in mode si_prepare).
//     K7 with a Halo: at a seam it reads the neighbour's edge row or column
//     of F and U (the ghost gather of (F, U) at weight 1, K12.1's), at a
//     global edge it takes the image at value 0, or the ghost for a periodic
//     field, by the rule `cross_at` shares with K12.1 (physics.cuh).  Each
//     cell runs K7's arithmetic on the values K7 reads, so a mesh equals K7
//     on the whole grid bit for bit.  Bound by bytes like K7.
//
// Float64: the counterpart of K13, `bachelors_tpu/ops/pallas_dd.py:
// _make_fullstep_kernel_dd` (:272, via `_fullstep_impl_dd` :607), which runs
// schemes euler (T <= 8), rk4, rkm and si on (hi, lo) float32 pairs because
// the TPU has no float64 ALU.  The H100 has one, so here those schemes are
// K6, K3, K2 and K7 instantiated at double (and K1, K4 for the single Euler
// steps and the staged RK4), with no pair arithmetic.  They compute in `Rn`,
// a double rounded at every operation (physics.cuh), so they round as the
// plain version does; that costs the FMA contractions.  Doubles double the
// tiles: K2 needs 91,456 B of shared memory, K3 76,800 B and K6 at T = 8
// 49,152 B, above the 48 KB a static array may take, so every tile kernel
// takes dynamic shared memory, allowed once per instantiation
// (`cudaFuncSetAttribute`) before its first launch.  The tiles keep their
// float32 size, so K2 and K3 fit two blocks per SM at double.  Every mesh
// kernel (K5, K12.1-K12.4, K12.7) is built at double too.
//
// K13 twins bt_rkm_attempt_apron_f64, bt_rk4_full_apron_f64 and
//     bt_euler_steps_apron_f64 (T = 4, 8): replace the sharded whole steps
//     of `pallas_dd.py` (`rkm_attempt_dd_pair_sharded` :1198,
//     `rk4_full_dd_pair_sharded` :1186, `euler_steps_dd_pair_sharded`
//     :1171, all through `_fullstep_impl_dd` :607 with ghost slabs and
//     ghost columns, the kernel's modes :323-457).  K2, K3 and K6 at double
//     on a shard of a y, x or 2D mesh, from an apron A cells deep (the
//     stage chain's depth: 5, 4, T) that `Topology.apron` fills once per
//     step: ghost rows and ghost columns of both fields, the rows widened
//     by A columns on a 2D mesh so that they carry the diagonal shards'
//     corners -- what JAX's two-phase exchange (`ghost_cols_dd` :1116, then
//     `ghost_slabs_dd` :1076, `_dd_ghosts` :1148) delivers.  The loader
//     (`load_region`) reads rows beyond the shard from the ghost rows,
//     columns beyond it from the ghost columns, corners from the widened
//     rows; the boundary rule stays at global coordinates (`rhs_at`), so a
//     cell past a non-periodic global edge is never read, a Dirichlet
//     corner of a 2D mesh comes out as on the whole grid, and every cell
//     runs K2's, K3's or K6's arithmetic on the values they read: a mesh
//     equals them on the whole grid bit for bit.  JAX's kernel applies the
//     per-stage images to its ghost planes in y-then-x order (`fix` :381,
//     `fix_x` :408); reading the image at the crossing needs no order.
//     Bound like K2, K3 and K6; shared memory does not grow (the region is
//     the one-device kernel's).  The float32 slab twins (K12.2, K12.5,
//     K12.6) are the y-mesh case of the same loader.
//
// Boundary rule (K1-K4, K6).  At every stage the *blend* x + sum w_i k_i
// is imaged at the domain edge, with Dirichlet value d * (1 + sum w_i)
// (`pallas_rhs.py:1036-1052`, `bachelors_tpu/ops/rhs.py:15-22`); K4 and
// K6 take d as given, as their JAX kernels do.  The apron is indexed by
// unwrapped global coordinates and loaded with wrapped values.  A neighbour
// read that crosses a domain edge takes, for a Neumann/Dirichlet field, the
// image of the cell's own blend value, and for a periodic field the apron
// cell, whose stages were computed like an interior cell's.  Stage values at
// apron cells outside the domain are computed but read only by periodic
// fields, for which they are exactly the wrapped cell's values -- so mixed
// Phi/T boundary types are exact too.
#include <cuda_runtime.h>

#include <type_traits>

#include "physics.cuh"

namespace bt {

// ------------------------------------------------------------- K1, K4 ----

constexpr int kK1BlockX = 32;
constexpr int kK1BlockY = 8;

template <class Real>
struct BlendArgs {
  const Real* F[4];
  const Real* U[4];
  Real w[4];  // w[0] is 1 and is not multiplied
};

template <int NS, class Real>
__device__ __forceinline__ Real blend_at(const Real* const* A, const Real* w, int idx) {
  Real v = A[0][idx];
#pragma unroll
  for (int k = 1; k < NS; ++k) v = v + A[k][idx] * w[k];
  return v;
}

// The blend sum_k w_k (F_k, U_k) at cell (i, j), as (Fc, Uc), and the RHS
// there, as (dF, dU), with the boundary rule applied to the blend, or the
// halo's ghosts (physics.cuh) at a shard's seams.
template <int NS, class Real>
__device__ __forceinline__ void blend_rhs_at(const BlendArgs<Real>& a, const Halo<Real>& h,
                                             int i, int j, int ny, int nx, Real d, Real fu,
                                             const PhysParams<Real>& P, Real& Fc,
                                             Real& Uc, Real& dF, Real& dU) {
  const int c = i * nx + j;
  const Real fc = blend_at<NS>(a.F, a.w, c);
  const Real uc = blend_at<NS>(a.U, a.w, c);
  const Cross<Real> f = cross_at([&](int idx) { return blend_at<NS>(a.F, a.w, idx); },
                                 P.f_bc, 0, fc, d, h, i, j, ny, nx);
  const Cross<Real> u = cross_at([&](int idx) { return blend_at<NS>(a.U, a.w, idx); },
                                 P.u_bc, 1, uc, d, h, i, j, ny, nx);
  physics(P, fc, f.N, f.S, f.E, f.W, uc, u.N, u.S, u.E, u.W, fu, dF, dU);
  Fc = fc;
  Uc = uc;
}

// K1 and, with a halo, K12.1
template <int NS, class Real>
__global__ void __launch_bounds__(kK1BlockX* kK1BlockY)
    blend_rhs_kernel(BlendArgs<Real> a, Real* __restrict__ outF,
                     Real* __restrict__ outU, int ny, int nx, Real d, Real fu,
                     int is_euler, Halo<Real> h, PhysParams<Real> P) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  Real Fc, Uc, dF, dU;
  blend_rhs_at<NS>(a, h, i, j, ny, nx, d, fu, P, Fc, Uc, dF, dU);
  if (is_euler) {
    dF = Fc + P.dt * dF;
    dU = Uc + P.dt * dU;
  }
  outF[i * nx + j] = dF;
  outU[i * nx + j] = dU;
}

// K4: a = {x, k3} with weights {1, dt}; the combination in the JAX
// kernel's order, x + c6 (((k1 + 2 k2) + 2 k3) + k4).  With a halo, K12.4 on
// a shard: the ghosts are those of the blend [x, k3].
template <class Real>
__global__ void __launch_bounds__(kK1BlockX* kK1BlockY)
    rk4_final_kernel(BlendArgs<Real> a, const Real* __restrict__ k1F,
                     const Real* __restrict__ k1U, const Real* __restrict__ k2F,
                     const Real* __restrict__ k2U, Real* __restrict__ outF,
                     Real* __restrict__ outU, int ny, int nx, Real c6, Real d,
                     Real fu, Halo<Real> h, PhysParams<Real> P) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  Real Fc, Uc, k4F, k4U;
  blend_rhs_at<2>(a, h, i, j, ny, nx, d, fu, P, Fc, Uc, k4F, k4U);
  const int c = i * nx + j;
  outF[c] = a.F[0][c] + c6 * (k1F[c] + Real(2) * k2F[c] + Real(2) * a.F[1][c] + k4F);
  outU[c] = a.U[0][c] + c6 * (k1U[c] + Real(2) * k2U[c] + Real(2) * a.U[1][c] + k4U);
}

// ------------------------------------------------- K5, K12.1's ghost gather ----

// K5: a = {x, k1, k3, k4} with weights {1, tau/2, -3 tau/2, 2 tau}; k5 at the
// cell, the update x + c6 (k1 + 4 k4 + k5) and the error |0.2 k1 - 0.9 k3 +
// 0.8 k4 - 0.1 k5| in the JAX kernel's order (`pallas_rhs.py:441-454`), its
// per-block maxima (NaN kept) into `partials` for reduce_partials_kernel.
template <class Real>
__global__ void __launch_bounds__(kK1BlockX* kK1BlockY)
    rkm_final_kernel(BlendArgs<Real> a, Real c6, Real* __restrict__ outF,
                     Real* __restrict__ outU, Real* __restrict__ partials, int ny, int nx,
                     Real d, Real fu, Halo<Real> h, PhysParams<Real> P) {
  constexpr int kThreads = kK1BlockX * kK1BlockY;
  __shared__ Real redF[kThreads], redU[kThreads];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  Real eF = Real(0), eU = Real(0);
  if (i < ny && j < nx) {  // no early return: every thread joins the reduction
    Real Fc, Uc, k5F, k5U;
    blend_rhs_at<4>(a, h, i, j, ny, nx, d, fu, P, Fc, Uc, k5F, k5U);
    const int c = i * nx + j;
    const Real k1F = a.F[1][c], k3F = a.F[2][c], k4F = a.F[3][c];
    const Real k1U = a.U[1][c], k3U = a.U[2][c], k4U = a.U[3][c];
    outF[c] = a.F[0][c] + c6 * (k1F + Real(4) * k4F + k5F);
    outU[c] = a.U[0][c] + c6 * (k1U + Real(4) * k4U + k5U);
    eF = abs_of(Real(0.2) * k1F - Real(0.9) * k3F + Real(0.8) * k4F - Real(0.1) * k5F);
    eU = abs_of(Real(0.2) * k1U - Real(0.9) * k3U + Real(0.8) * k4U - Real(0.1) * k5U);
  }
  redF[tid] = eF;
  redU[tid] = eU;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      redF[tid] = nan_max(redF[tid], redF[tid + half]);
      redU[tid] = nan_max(redU[tid], redU[tid + half]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[b] = redF[0];
    partials[gridDim.x * gridDim.y + b] = redU[0];
  }
}

constexpr int kEdgeThreads = 256;

// K12.1's ghost gather: the blend's first and last row (into `rows`, (2
// sides, 2 fields, nx)) and first and last column (`cols`, (2, 2, ny)), each
// null if not wanted; one thread per edge cell, K1's blend_at, so a seam
// reads exactly the blend the neighbour's own K1 forms.
template <int NS, class Real>
__global__ void __launch_bounds__(kEdgeThreads)
    halo_edges_kernel(BlendArgs<Real> a, Real* __restrict__ rows,
                      Real* __restrict__ cols, int ny, int nx) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_rows = rows != nullptr ? 2 * nx : 0;
  if (t < n_rows) {
    const int side = t / nx, j = t - side * nx;
    const int idx = (side ? ny - 1 : 0) * nx + j;
    rows[(side * 2) * nx + j] = blend_at<NS>(a.F, a.w, idx);
    rows[(side * 2 + 1) * nx + j] = blend_at<NS>(a.U, a.w, idx);
    return;
  }
  t -= n_rows;
  if (cols != nullptr && t < 2 * ny) {
    const int side = t / ny, i = t - side * ny;
    const int idx = i * nx + (side ? nx - 1 : 0);
    cols[(side * 2) * ny + i] = blend_at<NS>(a.F, a.w, idx);
    cols[(side * 2 + 1) * ny + i] = blend_at<NS>(a.U, a.w, idx);
  }
}

// -------------------------------------------------- apron tiles: K2, K3, K6 ----
//
// One block per 32x16 output tile.  The tile plus an apron of A cells on all
// four sides -- the depth of the stage chain -- is loaded once into shared
// memory; stage s is evaluated on the tile grown by the depth that the later
// stages still read, so no stage value leaves the SM.

constexpr int kTX = 32;  // tile width (x, contiguous)
constexpr int kTY = 16;  // tile height (y)
constexpr int kTileThreads = 256;
constexpr int kReduceThreads = 256;

// The tile kernels' shared memory, sized at launch (dynamic).
extern __shared__ __align__(16) unsigned char tile_smem[];

// The shared-memory region of a tile with an A-cell apron.
template <int A>
struct Region {
  static constexpr int W = kTX + 2 * A;
  static constexpr int H = kTY + 2 * A;
  static constexpr int N = W * H;
};

// What lies beyond a block's own fields (K12.2, K12.5, K12.6 and the K13
// twins).  The fields hold global rows [y0, y0 + ny_l) and columns [x0, x0 +
// nx_l) of the (ny, nx) grid: the whole grid, or one shard of a mesh.  Along
// an axis that is not sharded the block holds every row (column) and the
// apron wraps; along a sharded one it reads the neighbours' ghosts, in ring
// order, so at a periodic global edge they are the wrapped cells:
//   rows: (2 sides, 2 fields, A, W) -- side 0 the A rows below the shard,
//         side 1 the A rows above it; W = nx_l + 2A when columns are
//         sharded too (the ghost rows then carry the diagonal neighbours'
//         corners: columns [x0 - A, x0 + nx_l + A)), else W = nx_l = nx;
//   cols: (2 sides, 2 fields, ny_l, A) -- the A columns west and east.
// Null along an axis that is not sharded.
template <class Real>
struct Apron {
  const Real* rows;
  const Real* cols;
  int y0, ny_l, x0, nx_l;
};

template <class Real>
__host__ __device__ __forceinline__ Apron<Real> whole_apron(int ny, int nx) {
  return Apron<Real>{nullptr, nullptr, 0, ny, 0, nx};
}

// Where a tile's cells sit: region cell (ry, rx) is unwrapped global cell
// (gy0 + ry, gx0 + rx) of the (ny, nx) grid; the block's fields hold the
// apron's rows [y0, y0 + ny_l) and columns [x0, x0 + nx_l).
struct Tile {
  int gy0, gx0, ny, nx, y0, ny_l, x0, nx_l;
};

template <int A, class Real>
__device__ __forceinline__ Tile block_tile(int ny, int nx, const Apron<Real>& ap) {
  return Tile{ap.y0 + int(blockIdx.y) * kTY - A, ap.x0 + int(blockIdx.x) * kTX - A, ny, nx,
              ap.y0, ap.ny_l, ap.x0, ap.nx_l};
}

// (F, U) on the whole region.  Without GHOSTS (the whole grid) every cell
// is read at its wrapped coordinate, and the ghost branches are not built:
// on the whole grid they cost the tile kernels 2-7% (PERF.md §6).
// With them, along an axis without ghosts every cell is read at its wrapped
// coordinate; along one with ghosts the cells beyond the block come from
// them: rows beyond it from the ghost rows, columns beyond it from the ghost
// columns (at the wrapped row on an x-mesh, whose shards hold every row),
// and the corners from the ghost rows' widened ends.  Region cells more
// than A beyond a ragged last tile feed no owned cell; they repeat the last
// ghost row or column.
//
// A region that lies inside the block's own fields -- most tiles of a large
// grid -- is read without any of that: no wrap, no ghost branch (a test
// uniform over the block).
template <int A, bool GHOSTS, int NT = kTileThreads, class Real>
__device__ __forceinline__ void load_region(const Tile& T, const Real* __restrict__ F,
                                            const Real* __restrict__ U, const Apron<Real>& ap,
                                            Real* sF, Real* sU) {
  const int ly0 = T.gy0 - T.y0, lx0 = T.gx0 - T.x0;
  if (ly0 >= 0 && ly0 + Region<A>::H <= T.ny_l && lx0 >= 0 && lx0 + Region<A>::W <= T.nx_l) {
    for (int t = threadIdx.x; t < Region<A>::N; t += NT) {
      const int g = (ly0 + t / Region<A>::W) * T.nx_l + lx0 + t % Region<A>::W;
      sF[t] = F[g];
      sU[t] = U[g];
    }
    return;
  }
  if constexpr (!GHOSTS) {
    for (int t = threadIdx.x; t < Region<A>::N; t += NT) {
      const int g = wrap(T.gy0 + t / Region<A>::W, T.ny) * T.nx +
                    wrap(T.gx0 + t % Region<A>::W, T.nx);
      sF[t] = F[g];
      sU[t] = U[g];
    }
  } else {
    const int row_w = ap.cols != nullptr ? T.nx_l + 2 * A : T.nx_l;
    for (int t = threadIdx.x; t < Region<A>::N; t += NT) {
      const int gy = T.gy0 + t / Region<A>::W, gx = T.gx0 + t % Region<A>::W;
      const int ly = ap.rows != nullptr ? gy - T.y0 : wrap(gy, T.ny);
      const int lx = ap.cols != nullptr ? gx - T.x0 : wrap(gx, T.nx);
      const bool in_y = ly >= 0 && ly < T.ny_l, in_x = lx >= 0 && lx < T.nx_l;
      if (in_y && in_x) {
        const int g = ly * T.nx_l + lx;
        sF[t] = F[g];
        sU[t] = U[g];
        continue;
      }
      const Real* s;
      size_t field;  // the offset from a ghost's F value to its U value
      if (!in_y) {
        const int side = ly >= 0;
        const int r = side ? min(ly - T.ny_l, A - 1) : ly + A;
        const int c = ap.cols != nullptr ? min(lx + A, row_w - 1) : lx;
        s = ap.rows + (size_t(side) * 2 * A + r) * row_w + c;
        field = size_t(A) * row_w;
      } else {
        const int side = lx >= 0;
        const int c = side ? min(lx - T.nx_l, A - 1) : lx + A;
        s = ap.cols + (size_t(side) * 2 * T.ny_l + ly) * A + c;
        field = size_t(T.ny_l) * A;
      }
      sF[t] = s[0];
      sU[t] = s[field];
    }
  }
}

// Whether the tile's whole region lies inside the global domain: then no
// neighbour read of any stage crosses a domain edge (a test uniform over the
// block, made once per tile).
template <int A>
__device__ __forceinline__ bool interior(const Tile& T) {
  return T.gy0 >= 0 && T.gy0 + Region<A>::H <= T.ny && T.gx0 >= 0 &&
         T.gx0 + Region<A>::W <= T.nx;
}

// A stage's state read as x + w k, formed at each read of region cell c
// (`operator[]`), never stored: the sum eval_blend would have stored, in
// its order and rounding.
template <class Real>
struct XPlusWK {
  const Real* x;
  const Real* k;
  Real w;
  __device__ __forceinline__ Real operator[](int c) const { return x[c] + k[c] * w; }
};

// The RHS of the state (bF, bU) at region cell (ry, rx), with the boundary
// rule at Dirichlet value dv; the state is read by index, from shared
// memory or formed at the read (`XPlusWK`).  Without EDGES (an `interior`
// tile) every neighbour is the region's own cell: no wrap, no edge flags,
// no selects, the values `neighbour` would have passed through.  ISO: S =
// 0 (`physics`).
template <int A, bool EDGES = true, bool ISO = false, class Real, class State>
__device__ __forceinline__ void rhs_at(const Tile& T, const PhysParams<Real>& P, State bF,
                                       State bU, int ry, int rx, Real dv, Real fu, Real& dF,
                                       Real& dU) {
  constexpr int W = Region<A>::W;
  if constexpr (!EDGES) {
    const int c = ry * W + rx;
    physics<ISO>(P, bF[c], bF[c + W], bF[c - W], bF[c + 1], bF[c - 1], bU[c], bU[c + W],
                 bU[c - W], bU[c + 1], bU[c - 1], fu, dF, dU);
    return;
  }
  int gy = T.gy0 + ry, gx = T.gx0 + rx;
  bool cN = wrap(gy + 1, T.ny) == 0, cS = wrap(gy, T.ny) == 0;
  bool cE = wrap(gx + 1, T.nx) == 0, cW = wrap(gx, T.nx) == 0;
  int c = ry * W + rx;
  Real Fc = bF[c], Uc = bU[c];
  physics<ISO>(P, Fc, neighbour(P.f_bc, cN, bF[c + W], Fc, dv),
          neighbour(P.f_bc, cS, bF[c - W], Fc, dv),
          neighbour(P.f_bc, cE, bF[c + 1], Fc, dv),
          neighbour(P.f_bc, cW, bF[c - 1], Fc, dv), Uc,
          neighbour(P.u_bc, cN, bU[c + W], Uc, dv),
          neighbour(P.u_bc, cS, bU[c - W], Uc, dv),
          neighbour(P.u_bc, cE, bU[c + 1], Uc, dv),
          neighbour(P.u_bc, cW, bU[c - 1], Uc, dv), fu, dF, dU);
}

// k = f(b) -- with EULER, k = b + dt f(b) -- on the tile grown by `depth`
// cells; b must be valid one cell deeper.
template <int A, bool EULER = false, bool EDGES = true, bool ISO = false,
          int NT = kTileThreads, class Real, class State>
__device__ __forceinline__ void eval_stage(const Tile& T, const PhysParams<Real>& P,
                                           State bF, State bU, Real* kF, Real* kU, int depth,
                                           Real dv, Real fu) {
  const int w = kTX + 2 * depth, h = kTY + 2 * depth, lo = A - depth;
  for (int t = threadIdx.x; t < w * h; t += NT) {
    int ry = lo + t / w, rx = lo + t % w;
    int c = ry * Region<A>::W + rx;
    Real dF, dU;
    rhs_at<A, EDGES, ISO>(T, P, bF, bU, ry, rx, dv, fu, dF, dU);
    if (EULER) {
      dF = bF[c] + P.dt * dF;
      dU = bU[c] + P.dt * dU;
    }
    kF[c] = dF;
    kU[c] = dU;
  }
}

// b = x + sum_i w_i k_i on the tile grown by `depth` cells, summed in order.
template <int A, int NK, int NT = kTileThreads, class Real>
__device__ __forceinline__ void eval_blend(const Real* xF, const Real* xU,
                                           const Real* const* kF, const Real* const* kU,
                                           const Real* w, Real* bF, Real* bU, int depth) {
  const int wd = kTX + 2 * depth, h = kTY + 2 * depth, lo = A - depth;
  for (int t = threadIdx.x; t < wd * h; t += NT) {
    int c = (lo + t / wd) * Region<A>::W + lo + t % wd;
    Real vF = xF[c], vU = xU[c];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      vF = vF + kF[k][c] * w[k];
      vU = vU + kU[k][c] * w[k];
    }
    bF[c] = vF;
    bU[c] = vU;
  }
}

// f(ry, rx, g) for every owned cell of the tile inside the block; g is the
// cell's index in the block's (ny_l, nx_l) fields.
template <int A, int NT = kTileThreads, class Fn>
__device__ __forceinline__ void for_owned(const Tile& T, Fn f) {
  for (int t = threadIdx.x; t < kTX * kTY; t += NT) {
    int ry = A + t / kTX, rx = A + t % kTX;
    int ly = T.gy0 + ry - T.y0, lx = T.gx0 + rx - T.x0;
    if (ly >= T.ny_l || lx >= T.nx_l) continue;  // ragged tile edge
    f(ry, rx, ly * T.nx_l + lx);
  }
}

// ---------------------------------------------------------------- K2 ----

constexpr int kK2Apron = 5;  // Merson reads 5 stages deep
constexpr int kK2N = Region<kK2Apron>::N;

// K2's block: threads, and the blocks an SM must hold (the register cap),
// as measured at 512^2 and 2048^2 (PERF.md §6).  At double the tile takes
// 87.6 KB of shared memory, so an SM holds two blocks; with atan2 and cos
// (S != 0) 512 threads -- 32 warps an SM instead of 16, at the same 64
// registers a thread -- took 7-11% off the 256-thread block, while the
// isotropic instantiation ran 3-5% faster with 256.  At float four blocks
// of 256 fit an SM; 512 threads were 10-47% slower.
template <class Real, bool ISO>
struct K2Block {
  static constexpr int kThreads = 256, kMinBlocks = 1;
};
template <>
struct K2Block<Rn, false> {
  static constexpr int kThreads = 512, kMinBlocks = 2;
};

template <class Real, int NT>
struct RkmSmem {
  Real xF[kK2N], xU[kK2N];    // the attempt's start state
  Real k1F[kK2N], k1U[kK2N];
  Real kaF[kK2N], kaU[kK2N];  // k2, then k3
  Real k4F[kK2N], k4U[kK2N];
  Real bF[kK2N], bU[kK2N];    // the current stage's blend
  Real red[2 * NT / 32];      // the error maxima of each warp
};

__device__ __forceinline__ float shfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ Rn shfl_down(Rn v, int off) {
  return __shfl_down_sync(0xffffffffu, v.v, off);
}

// The block's maxima of a and b (NaN kept), valid in thread 0: across each
// warp by shuffles, then across the warps.  A max is exact in any order.
template <int NT, class Real>
__device__ __forceinline__ void block_max2(Real& a, Real& b, Real* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = nan_max(a, shfl_down(a, off));
    b = nan_max(b, shfl_down(b, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[NT / 32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < NT / 32 ? red[lane] : Real(0);
    b = lane < NT / 32 ? red[NT / 32 + lane] : Real(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a = nan_max(a, shfl_down(a, off));
      b = nan_max(b, shfl_down(b, off));
    }
  }
}

// Merson's five stages on a loaded tile, the update and the block's error
// maxima (`simulation.cu:400-404`); weights in the field type, as the
// staged path computes them from a tau of that type.  EDGES: the tile's
// region crosses a domain edge, so every neighbour read takes the boundary
// rule; ISO: S = 0.
template <bool EDGES, bool ISO, int NT, class Real>
__device__ __forceinline__ void rkm_stages(const Tile& T, RkmSmem<Real, NT>& s,
                                           const PhysParams<Real>& P, Real tau, Real d,
                                           Real fu, Real* __restrict__ outF,
                                           Real* __restrict__ outU,
                                           Real* __restrict__ partials) {
  constexpr int A = kK2Apron;
  eval_stage<A, false, EDGES, ISO, NT>(T, P, s.xF, s.xU, s.k1F, s.k1U, 4, d, fu);
  __syncthreads();
  {
    const Real* kF[1] = {s.k1F};
    const Real* kU[1] = {s.k1U};
    const Real w[1] = {tau / Real(3)};
    eval_blend<A, 1, NT>(s.xF, s.xU, kF, kU, w, s.bF, s.bU, 4);
    __syncthreads();
    eval_stage<A, false, EDGES, ISO, NT>(T, P, s.bF, s.bU, s.kaF, s.kaU, 3,
                                         d * (Real(1) + w[0]), fu);
    __syncthreads();
  }
  {
    const Real* kF[2] = {s.k1F, s.kaF};
    const Real* kU[2] = {s.k1U, s.kaU};
    const Real w[2] = {tau / Real(6), tau / Real(6)};
    eval_blend<A, 2, NT>(s.xF, s.xU, kF, kU, w, s.bF, s.bU, 3);
    __syncthreads();  // k2 is dead from here: k3 takes its arrays
    eval_stage<A, false, EDGES, ISO, NT>(T, P, s.bF, s.bU, s.kaF, s.kaU, 2,
                                         d * (Real(1) + w[0] + w[1]), fu);
    __syncthreads();
  }
  {
    const Real* kF[2] = {s.k1F, s.kaF};
    const Real* kU[2] = {s.k1U, s.kaU};
    const Real w[2] = {tau / Real(8), Real(3) * tau / Real(8)};
    eval_blend<A, 2, NT>(s.xF, s.xU, kF, kU, w, s.bF, s.bU, 2);
    __syncthreads();
    eval_stage<A, false, EDGES, ISO, NT>(T, P, s.bF, s.bU, s.k4F, s.k4U, 1,
                                         d * (Real(1) + w[0] + w[1]), fu);
    __syncthreads();
  }
  const Real w5[3] = {tau / Real(2), Real(-3) * tau / Real(2), Real(2) * tau};
  {
    const Real* kF[3] = {s.k1F, s.kaF, s.k4F};
    const Real* kU[3] = {s.k1U, s.kaU, s.k4U};
    eval_blend<A, 3, NT>(s.xF, s.xU, kF, kU, w5, s.bF, s.bU, 1);
    __syncthreads();
  }

  // k5 on the owned cells, the 5th-order update and the error combination
  const Real dv = d * (Real(1) + w5[0] + w5[1] + w5[2]);
  const Real c6 = tau / Real(6);
  Real eF = Real(0), eU = Real(0);
  for_owned<A, NT>(T, [&](int ry, int rx, int g) {
    const int c = ry * Region<A>::W + rx;
    Real k5F, k5U;
    rhs_at<A, EDGES, ISO>(T, P, s.bF, s.bU, ry, rx, dv, fu, k5F, k5U);
    outF[g] = s.xF[c] + c6 * (s.k1F[c] + Real(4) * s.k4F[c] + k5F);
    outU[g] = s.xU[c] + c6 * (s.k1U[c] + Real(4) * s.k4U[c] + k5U);
    eF = nan_max(eF, abs_of(Real(0.2) * s.k1F[c] - Real(0.9) * s.kaF[c] +
                            Real(0.8) * s.k4F[c] - Real(0.1) * k5F));
    eU = nan_max(eU, abs_of(Real(0.2) * s.k1U[c] - Real(0.9) * s.kaU[c] +
                            Real(0.8) * s.k4U[c] - Real(0.1) * k5U));
  });
  block_max2<NT>(eF, eU, s.red);
  if (threadIdx.x == 0) {
    int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[b] = eF;
    partials[gridDim.x * gridDim.y + b] = eU;
  }
}

// One whole Merson attempt on one tile.  Where K2's time went (PERF.md
// §6): every evaluation tested four neighbours against the domain edges
// with integer modulos, and evaluated atan2 and cos even at S = 0.  Here a
// tile whose region lies inside the domain (82% of them at 512^2) runs the
// stages without any edge test, the isotropic instantiation (ISO, chosen
// by the host when S = 0) skips atan2 and cos, and at double with atan2
// and cos a block of 512 threads (`K2Block`) halves each thread's serial
// share of the tile's ~3640 evaluations.  Every cell still runs the same operations in the
// same order on the same values as the plain version, so the result is the
// same bit for bit.
template <bool GHOSTS, bool ISO, class Real>
__global__ void __launch_bounds__(K2Block<Real, ISO>::kThreads,
                                  K2Block<Real, ISO>::kMinBlocks)
    rkm_attempt_kernel(const Real* __restrict__ F, const Real* __restrict__ U,
                       Real* __restrict__ outF, Real* __restrict__ outU,
                       Real* __restrict__ partials, Apron<Real> ap, int ny, int nx,
                       Real tau, Real d, Real fu, PhysParams<Real> P) {
  constexpr int A = kK2Apron, NT = K2Block<Real, ISO>::kThreads;
  RkmSmem<Real, NT>& s = *reinterpret_cast<RkmSmem<Real, NT>*>(tile_smem);
  const Tile T = block_tile<A>(ny, nx, ap);
  load_region<A, GHOSTS, NT>(T, F, U, ap, s.xF, s.xU);
  __syncthreads();
  if (interior<A>(T))
    rkm_stages<false, ISO, NT>(T, s, P, tau, d, fu, outF, outU, partials);
  else
    rkm_stages<true, ISO, NT>(T, s, P, tau, d, fu, outF, outU, partials);
}

// err[0] = max of partials[0:n], err[1] = max of partials[n:2n]
template <class Real>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const Real* __restrict__ partials, int n,
                           Real* __restrict__ err) {
  __shared__ Real rF[kReduceThreads], rU[kReduceThreads];
  Real mF = Real(0), mU = Real(0);
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

// ---------------------------------------------------------------- K3 ----

constexpr int kK3Apron = 4;  // RK4 reads 4 stages deep
constexpr int kK3N = Region<kK3Apron>::N;

// x, k1, k2 and k3 of both fields on the tile's region: 8 arrays, 30,720 B
// at float and 61,440 B at double (three blocks an SM).  No stage's state
// x + w k is stored: each stage forms it at its reads (`XPlusWK`).
template <class Real>
struct Rk4Smem {
  Real xF[kK3N], xU[kK3N];  // the step's start state
  Real k1F[kK3N], k1U[kK3N];
  Real k2F[kK3N], k2U[kK3N];
  Real k3F[kK3N], k3U[kK3N];
};

// RK4's four stages on a loaded tile and the combination
// (`simulation.cu:313-348`): k1 = f(x), k2 = f(x + h k1), k3 = f(x + h k2),
// k4 = f(x + dt k3) with h = dt/2, then x + c6 (k1 + 2 k2 + 2 k3 + k4),
// c6 = dt/6 -- the weights as the host rounds them, as the JAX kernel
// takes them.  EDGES: the tile's region crosses a domain edge; ISO: S = 0.
template <bool EDGES, bool ISO, class Real>
__device__ __forceinline__ void rk4_stages(const Tile& T, Rk4Smem<Real>& s,
                                           const PhysParams<Real>& P, Real h, Real dt,
                                           Real c6, Real d, Real fu, Real* __restrict__ outF,
                                           Real* __restrict__ outU) {
  constexpr int A = kK3Apron;
  using X = XPlusWK<Real>;
  eval_stage<A, false, EDGES, ISO>(T, P, s.xF, s.xU, s.k1F, s.k1U, 3, d, fu);
  __syncthreads();
  const Real dh = d * (Real(1) + h);
  eval_stage<A, false, EDGES, ISO>(T, P, X{s.xF, s.k1F, h}, X{s.xU, s.k1U, h}, s.k2F, s.k2U,
                                   2, dh, fu);
  __syncthreads();
  eval_stage<A, false, EDGES, ISO>(T, P, X{s.xF, s.k2F, h}, X{s.xU, s.k2U, h}, s.k3F, s.k3U,
                                   1, dh, fu);
  __syncthreads();

  // k4 on the owned cells and the combination
  const Real dv = d * (Real(1) + dt);
  const X bF{s.xF, s.k3F, dt}, bU{s.xU, s.k3U, dt};
  for_owned<A>(T, [&](int ry, int rx, int g) {
    const int c = ry * Region<A>::W + rx;
    Real k4F, k4U;
    rhs_at<A, EDGES, ISO>(T, P, bF, bU, ry, rx, dv, fu, k4F, k4U);
    outF[g] = s.xF[c] + c6 * (s.k1F[c] + Real(2) * s.k2F[c] + Real(2) * s.k3F[c] + k4F);
    outU[g] = s.xU[c] + c6 * (s.k1U[c] + Real(2) * s.k2U[c] + Real(2) * s.k3U[c] + k4U);
  });
}

// One whole RK4 step on one tile.  Where K3's time went (PERF.md §6): every
// evaluation tested four neighbours against the domain edges with integer
// modulos, evaluated atan2 and cos even at S = 0, and each stage first
// stored its blend for the next to read.  As K2 now: a tile whose region
// lies inside the domain (97.7% of them at 4096^2) runs its stages without
// edge tests, and at S = 0 the host launches the isotropic instantiation
// (no atan2, no cos); and each stage forms x + w k at its reads, three
// fewer passes and barriers.  256 threads a block and 32x16 tiles: 512
// threads were slower from 2048^2 in every instantiation, stored blends at
// 2048^2 in every one, 32x32 and 64x16 tiles at double (PERF.md §6).  Every
// cell runs the same operations in the same order on the same values as
// the plain version, so the result is the same bit for bit.
// With ghosts 4 deep (K3's apron), K12.6 on a y-mesh shard and the K13
// twin on any shard, as K12.2 is K2 on a y-mesh shard.
template <bool GHOSTS, bool ISO, class Real>
__global__ void __launch_bounds__(kTileThreads)
    rk4_full_kernel(const Real* __restrict__ F, const Real* __restrict__ U,
                    Real* __restrict__ outF, Real* __restrict__ outU,
                    Apron<Real> ap, int ny, int nx, Real h, Real dt, Real c6, Real d,
                    Real fu, PhysParams<Real> P) {
  constexpr int A = kK3Apron;
  Rk4Smem<Real>& s = *reinterpret_cast<Rk4Smem<Real>*>(tile_smem);
  const Tile T = block_tile<A>(ny, nx, ap);
  load_region<A, GHOSTS>(T, F, U, ap, s.xF, s.xU);
  __syncthreads();
  if (interior<A>(T))
    rk4_stages<false, ISO>(T, s, P, h, dt, c6, d, fu, outF, outU);
  else
    rk4_stages<true, ISO>(T, s, P, h, dt, c6, d, fu, outF, outU);
}

// ---------------------------------------------------------------- K6 ----

// (F, U) of two successive steps: 4 arrays of the region
template <class Real, int STEPS>
constexpr int euler_smem_bytes() {
  return 4 * Region<STEPS>::N * int(sizeof(Real));
}

// With ghosts STEPS deep (its apron), K12.5 on a y-mesh shard and the K13
// twin on any shard, as K12.2 is K2 on a y-mesh shard.
template <int STEPS, bool GHOSTS, class Real>
__global__ void __launch_bounds__(kTileThreads)
    euler_steps_kernel(const Real* __restrict__ F, const Real* __restrict__ U,
                       Real* __restrict__ outF, Real* __restrict__ outU,
                       Apron<Real> ap, int ny, int nx, Real d, Real fu,
                       PhysParams<Real> P) {
  // (F, U) of two successive steps: buf[0..1], then buf[2..3], in turns
  constexpr int N = Region<STEPS>::N;
  Real(*buf)[N] = reinterpret_cast<Real(*)[N]>(tile_smem);
  const Tile T = block_tile<STEPS>(ny, nx, ap);
  load_region<STEPS, GHOSTS>(T, F, U, ap, buf[0], buf[1]);
  __syncthreads();
#pragma unroll
  for (int step = 0; step < STEPS; ++step) {
    const int cur = 2 * (step & 1), nxt = 2 - cur;
    eval_stage<STEPS, true>(T, P, buf[cur], buf[cur + 1], buf[nxt], buf[nxt + 1],
                            STEPS - 1 - step, d, fu);
    __syncthreads();
  }
  constexpr int last = 2 * (STEPS & 1);
  for_owned<STEPS>(T, [&](int ry, int rx, int g) {
    const int c = ry * Region<STEPS>::W + rx;
    outF[g] = buf[last][c];
    outU[g] = buf[last + 1][c];
  });
}

// ----------------------------------------------------------- K7, K12.7 ----

// K7 on the whole grid (h = whole_grid) or, with a halo (the ghosts of F and
// U), K12.7 on a shard.  Ghosts and images take Dirichlet value 0, as the
// JAX package's prepare does.
template <class Real>
__global__ void __launch_bounds__(kK1BlockX* kK1BlockY)
    si_prepare_kernel(const Real* __restrict__ F, const Real* __restrict__ U,
                      Real* __restrict__ r0, Real* __restrict__ uterm,
                      Real* __restrict__ s_out, int ny, int nx, Halo<Real> h,
                      PhysParams<Real> P) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const int c = i * nx + j;
  const Real Fc = F[c], Uc = U[c];
  const Cross<Real> f = cross_at(Load<Real>{F}, P.f_bc, 0, Fc, Real(0), h, i, j, ny, nx);
  const Cross<Real> u = cross_at(Load<Real>{U}, P.u_bc, 1, Uc, Real(0), h, i, j, ny, nx);

  Real g, norm;
  anisotropy(P, (f.E - f.W) * P.inv_2dx, (f.N - f.S) * P.inv_2dy, g, norm);
  Real lapF = (f.W - Real(2) * Fc + f.E) * P.inv_dx2 + (f.S - Real(2) * Fc + f.N) * P.inv_dy2;
  Real lapU = (u.W - Real(2) * Uc + u.E) * P.inv_dx2 + (u.S - Real(2) * Uc + u.N) * P.inv_dy2;
  Real k0 = g * (Fc * (Real(1) - Fc) * (Fc - Real(0.5))) * P.k0_factor;
  Real k2 = norm * P.k2_factor;
  Real k1 = g * P.k1_factor;

  Real r, sv;
  if (P.corrector_guess) {
    Real corr = Real(1) + k2 * P.dt * P.L;
    r = P.dt / corr * (k1 * lapF + k0 - k2 * (Uc - P.Tm + P.dt * lapU));
    sv = P.gamma / corr * k1;
  } else {
    r = P.dt * (k1 * lapF + k0 - k2 * (Uc - P.Tm));
    sv = P.gamma * k1;
  }
  r0[c] = r;
  uterm[c] = P.dt * lapU;
  if (s_out != nullptr) s_out[c] = sv;
}

}  // namespace bt

namespace {

using bt::PhysParams;

// The arithmetic type of a field type: float64 fields compute in bt::Rn.
template <class S>
struct ArithOf {
  using type = S;
};
template <>
struct ArithOf<double> {
  using type = bt::Rn;
};
template <class S>
using Ar = typename ArithOf<S>::type;

// The float64 kernels read and write the caller's double buffers as Rn.  Rn
// is a standard-layout, trivially copyable struct whose one member is a
// double, so the two share size, alignment and address (checked here), and
// the struct is pointer-interconvertible with its member.  Strict aliasing
// does not bless the cast itself; what it relies on is that inside a kernel
// every access to such a buffer goes through Rn (none through double), and
// that nvcc's type-based alias analysis, like clang's struct-path TBAA,
// treats an access to Rn::v as an access to a double.
static_assert(sizeof(bt::Rn) == sizeof(double) && alignof(bt::Rn) == alignof(double),
              "Rn must lay out as a double");
static_assert(std::is_standard_layout<bt::Rn>::value &&
                  std::is_trivially_copyable<bt::Rn>::value,
              "Rn must be a plain wrapper of one double");

template <class S>
const Ar<S>* ar(const S* p) {
  return reinterpret_cast<const Ar<S>*>(p);
}
template <class S>
Ar<S>* ar(S* p) {
  return reinterpret_cast<Ar<S>*>(p);
}

dim3 k1_grid(int ny, int nx) {
  return dim3((nx + bt::kK1BlockX - 1) / bt::kK1BlockX,
              (ny + bt::kK1BlockY - 1) / bt::kK1BlockY);
}

dim3 tile_grid(int ny, int nx) {
  return dim3((nx + bt::kTX - 1) / bt::kTX, (ny + bt::kTY - 1) / bt::kTY);
}

// Lets `kernel` take `bytes` of dynamic shared memory (required above 48
// KB).  Each caller keeps the result in a function-local static, so this
// runs once per kernel instantiation, before its first launch.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class S>
bt::BlendArgs<Ar<S>> blend_args(const S* F0, const S* U0, const S* F1, const S* U1,
                                const S* F2, const S* U2, const S* F3, const S* U3, S w1,
                                S w2, S w3) {
  using R = Ar<S>;
  return bt::BlendArgs<R>{{ar(F0), ar(F1), ar(F2), ar(F3)},
                          {ar(U0), ar(U1), ar(U2), ar(U3)},
                          {R(1), R(w1), R(w2), R(w3)}};
}

// K1 on the whole grid (h = whole_grid) or, with a halo, K12.1 on a shard
template <class S>
int blend_rhs(const S* F0, const S* U0, const S* F1, const S* U1, const S* F2,
              const S* U2, const S* F3, const S* U3, int n_states, S w1, S w2, S w3,
              S* outF, S* outU, int ny, int nx, S d, S fu, int is_euler,
              bt::Halo<Ar<S>> h, const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  using R = Ar<S>;
  bt::BlendArgs<R> a = blend_args(F0, U0, F1, U1, F2, U2, F3, U3, w1, w2, w3);
  dim3 block(bt::kK1BlockX, bt::kK1BlockY), grid = k1_grid(ny, nx);
  switch (n_states) {
    case 1: bt::blend_rhs_kernel<1><<<grid, block, 0, stream>>>(a, ar(outF), ar(outU), ny, nx, R(d), R(fu), is_euler, h, *P); break;
    case 2: bt::blend_rhs_kernel<2><<<grid, block, 0, stream>>>(a, ar(outF), ar(outU), ny, nx, R(d), R(fu), is_euler, h, *P); break;
    case 3: bt::blend_rhs_kernel<3><<<grid, block, 0, stream>>>(a, ar(outF), ar(outU), ny, nx, R(d), R(fu), is_euler, h, *P); break;
    case 4: bt::blend_rhs_kernel<4><<<grid, block, 0, stream>>>(a, ar(outF), ar(outU), ny, nx, R(d), R(fu), is_euler, h, *P); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// K4 on the whole grid (h = whole_grid) or, with a halo, K12.4 on a shard
template <class S>
int rk4_final(const S* xF, const S* xU, const S* k1F, const S* k1U, const S* k2F,
              const S* k2U, const S* k3F, const S* k3U, S* outF, S* outU, int ny, int nx,
              S dt, S c6, S d, S fu, bt::Halo<Ar<S>> h, const PhysParams<Ar<S>>* P,
              cudaStream_t stream) {
  using R = Ar<S>;
  bt::BlendArgs<R> a{{ar(xF), ar(k3F), nullptr, nullptr}, {ar(xU), ar(k3U), nullptr, nullptr},
                     {R(1), R(dt), R(0), R(0)}};
  dim3 block(bt::kK1BlockX, bt::kK1BlockY);
  bt::rk4_final_kernel<<<k1_grid(ny, nx), block, 0, stream>>>(
      a, ar(k1F), ar(k1U), ar(k2F), ar(k2U), ar(outF), ar(outU), ny, nx, R(c6), R(d),
      R(fu), h, *P);
  return int(cudaGetLastError());
}

// The tile kernels' apron in their arithmetic type: the whole (ny, nx) grid
// with null ghosts, or a shard holding rows [y0, y0 + ny_l) and columns
// [x0, x0 + nx_l) with the ghosts of its sharded axes.
template <class S>
bt::Apron<Ar<S>> apron_of(const S* rows, const S* cols, int y0, int ny_l, int x0, int nx_l) {
  return bt::Apron<Ar<S>>{ar(rows), ar(cols), y0, ny_l, x0, nx_l};
}

// Whether a coefficient is 0 (on the host: Rn's operators are the device's)
inline bool is_zero(float x) { return x == 0.0f; }
inline bool is_zero(bt::Rn x) { return x.v == 0.0; }

// Whether a tile kernel's apron holds ghosts: the whole grid (null ghosts)
// takes the kernel instantiation built without the ghost branches.
template <class R>
bool has_ghosts(const bt::Apron<R>& ap) {
  return ap.rows != nullptr || ap.cols != nullptr;
}

// K2 on the whole grid (bt::whole_apron) or on a shard with its ghosts:
// K12.2 (a y-mesh, float32) or the K13 twin (any mesh, float64); the
// isotropic instantiation when S = 0
template <class S, bool GHOSTS, bool ISO>
int rkm_attempt_on(const S* F, const S* U, S* outF, S* outU, S* partials, S* err,
                   bt::Apron<Ar<S>> ap, int ny, int nx, S tau, S d, S fu,
                   const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  using R = Ar<S>;
  constexpr int threads = bt::K2Block<R, ISO>::kThreads;
  constexpr int smem = int(sizeof(bt::RkmSmem<R, threads>));
  static const cudaError_t attr = allow_smem(bt::rkm_attempt_kernel<GHOSTS, ISO, R>, smem);
  if (attr != cudaSuccess) return int(attr);
  dim3 grid = tile_grid(ap.ny_l, ap.nx_l);
  bt::rkm_attempt_kernel<GHOSTS, ISO><<<grid, threads, smem, stream>>>(
      ar(F), ar(U), ar(outF), ar(outU), ar(partials), ap, ny, nx, R(tau), R(d), R(fu), *P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bt::reduce_partials_kernel<<<1, bt::kReduceThreads, 0, stream>>>(
      ar(static_cast<const S*>(partials)), int(grid.x * grid.y), ar(err));
  return int(cudaGetLastError());
}

template <class S>
int rkm_attempt(const S* F, const S* U, S* outF, S* outU, S* partials, S* err,
                bt::Apron<Ar<S>> ap, int ny, int nx, S tau, S d, S fu,
                const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  const bool iso = is_zero(P->S);
  auto on = has_ghosts(ap)
                ? (iso ? rkm_attempt_on<S, true, true> : rkm_attempt_on<S, true, false>)
                : (iso ? rkm_attempt_on<S, false, true> : rkm_attempt_on<S, false, false>);
  return on(F, U, outF, outU, partials, err, ap, ny, nx, tau, d, fu, P, stream);
}

// K3 on the whole grid or on a shard: K12.6 (float32) or the K13 twin
// (float64); the isotropic instantiation when S = 0
template <class S, bool GHOSTS, bool ISO>
int rk4_full_on(const S* F, const S* U, S* outF, S* outU, bt::Apron<Ar<S>> ap, int ny,
                int nx, S h, S dt, S c6, S d, S fu, const PhysParams<Ar<S>>* P,
                cudaStream_t stream) {
  using R = Ar<S>;
  constexpr int smem = int(sizeof(bt::Rk4Smem<R>));
  static const cudaError_t attr = allow_smem(bt::rk4_full_kernel<GHOSTS, ISO, R>, smem);
  if (attr != cudaSuccess) return int(attr);
  bt::rk4_full_kernel<GHOSTS, ISO>
      <<<tile_grid(ap.ny_l, ap.nx_l), bt::kTileThreads, smem, stream>>>(
          ar(F), ar(U), ar(outF), ar(outU), ap, ny, nx, R(h), R(dt), R(c6), R(d), R(fu),
          *P);
  return int(cudaGetLastError());
}

template <class S>
int rk4_full(const S* F, const S* U, S* outF, S* outU, bt::Apron<Ar<S>> ap, int ny, int nx,
             S h, S dt, S c6, S d, S fu, const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  const bool iso = is_zero(P->S);
  auto on = has_ghosts(ap) ? (iso ? rk4_full_on<S, true, true> : rk4_full_on<S, true, false>)
                           : (iso ? rk4_full_on<S, false, true> : rk4_full_on<S, false, false>);
  return on(F, U, outF, outU, ap, ny, nx, h, dt, c6, d, fu, P, stream);
}

template <class S, int STEPS, bool GHOSTS>
int euler_steps_on(const S* F, const S* U, S* outF, S* outU, bt::Apron<Ar<S>> ap, int ny,
                   int nx, S d, S fu, const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  using R = Ar<S>;
  constexpr int smem = bt::euler_smem_bytes<R, STEPS>();
  static const cudaError_t attr = allow_smem(bt::euler_steps_kernel<STEPS, GHOSTS, R>, smem);
  if (attr != cudaSuccess) return int(attr);
  bt::euler_steps_kernel<STEPS, GHOSTS>
      <<<tile_grid(ap.ny_l, ap.nx_l), bt::kTileThreads, smem, stream>>>(
          ar(F), ar(U), ar(outF), ar(outU), ap, ny, nx, R(d), R(fu), *P);
  return int(cudaGetLastError());
}

template <class S, int STEPS>
int euler_steps_at(const S* F, const S* U, S* outF, S* outU, bt::Apron<Ar<S>> ap, int ny,
                   int nx, S d, S fu, const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  return (has_ghosts(ap) ? euler_steps_on<S, STEPS, true> : euler_steps_on<S, STEPS, false>)(
      F, U, outF, outU, ap, ny, nx, d, fu, P, stream);
}

// K6 (and its twins on a shard) is built for the depths its paths take: 4
// at float32, 4 and 8 at float64 (`pallas_dd.py:euler_dd_block_steps`).
template <class S>
int euler_steps(const S* F, const S* U, S* outF, S* outU, bt::Apron<Ar<S>> ap, int ny,
                int nx, int steps, S d, S fu, const PhysParams<Ar<S>>* P,
                cudaStream_t stream) {
  if (steps == 4) return euler_steps_at<S, 4>(F, U, outF, outU, ap, ny, nx, d, fu, P, stream);
  if constexpr (sizeof(S) == 8) {
    if (steps == 8)
      return euler_steps_at<S, 8>(F, U, outF, outU, ap, ny, nx, d, fu, P, stream);
  }
  return int(cudaErrorInvalidValue);
}

// K7 on the whole grid (h = whole_grid) or, with a halo, K12.7 on a shard
template <class S>
int si_prepare(const S* F, const S* U, S* r0, S* uterm, S* s, int ny, int nx,
               bt::Halo<Ar<S>> h, const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  dim3 block(bt::kK1BlockX, bt::kK1BlockY);
  bt::si_prepare_kernel<<<k1_grid(ny, nx), block, 0, stream>>>(
      ar(F), ar(U), ar(r0), ar(uterm), ar(s), ny, nx, h, *P);
  return int(cudaGetLastError());
}

// K5 on the whole grid (h = whole_grid) or on a shard: a = {x, k1, k3, k4}
template <class S>
int rkm_final(const S* xF, const S* xU, const S* k1F, const S* k1U, const S* k3F,
              const S* k3U, const S* k4F, const S* k4U, S w1, S w2, S w3, S c6, S* outF,
              S* outU, S* partials, S* err, int ny, int nx, S d, S fu, bt::Halo<Ar<S>> h,
              const PhysParams<Ar<S>>* P, cudaStream_t stream) {
  using R = Ar<S>;
  bt::BlendArgs<R> a = blend_args(xF, xU, k1F, k1U, k3F, k3U, k4F, k4U, w1, w2, w3);
  dim3 block(bt::kK1BlockX, bt::kK1BlockY), grid = k1_grid(ny, nx);
  bt::rkm_final_kernel<<<grid, block, 0, stream>>>(a, R(c6), ar(outF), ar(outU),
                                                   ar(partials), ny, nx, R(d), R(fu), h, *P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bt::reduce_partials_kernel<<<1, bt::kReduceThreads, 0, stream>>>(
      ar(static_cast<const S*>(partials)), int(grid.x * grid.y), ar(err));
  return int(cudaGetLastError());
}

template <class S>
int halo_edges(const S* F0, const S* U0, const S* F1, const S* U1, const S* F2,
               const S* U2, const S* F3, const S* U3, int n_states, S w1, S w2, S w3,
               S* rows, S* cols, int ny, int nx, cudaStream_t stream) {
  bt::BlendArgs<Ar<S>> a = blend_args(F0, U0, F1, U1, F2, U2, F3, U3, w1, w2, w3);
  const int n = (rows ? 2 * nx : 0) + (cols ? 2 * ny : 0);
  if (n == 0) return int(cudaSuccess);
  dim3 grid((n + bt::kEdgeThreads - 1) / bt::kEdgeThreads);
  switch (n_states) {
    case 1: bt::halo_edges_kernel<1><<<grid, bt::kEdgeThreads, 0, stream>>>(a, ar(rows), ar(cols), ny, nx); break;
    case 2: bt::halo_edges_kernel<2><<<grid, bt::kEdgeThreads, 0, stream>>>(a, ar(rows), ar(cols), ny, nx); break;
    case 3: bt::halo_edges_kernel<3><<<grid, bt::kEdgeThreads, 0, stream>>>(a, ar(rows), ar(cols), ny, nx); break;
    case 4: bt::halo_edges_kernel<4><<<grid, bt::kEdgeThreads, 0, stream>>>(a, ar(rows), ar(cols), ny, nx); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

template <class S>
bt::Halo<Ar<S>> halo_of(const S* rows, const S* cols, int edges) {
  return bt::Halo<Ar<S>>{ar(rows), ar(cols), edges};
}

}  // namespace

// The C interface: one set of entry points per field type, `bt_*_f32` on
// float32 fields and `bt_*_f64` on float64 ones (SFX, field type S).
// Scalars come in the field type, P as the kernels' PhysParams.
//   K1 bt_blend_rhs: out = f(sum_k w_k (F_k, U_k)), or the blend + dt * f in
//      euler mode.  F1..F3 / U1..U3 are ignored beyond n_states; w1..w3
//      weight them.
//   K4 bt_rk4_final: k4 = f(x + dt k3) at Dirichlet value d, out = x + c6
//      (k1 + 2 k2 + 2 k3 + k4).  c6 is dt/6 as the host rounds it.
//   K2 bt_rkm_attempt: one Merson attempt.  outF/outU get x + tau/6 (k1 +
//      4 k4 + k5); err[0], err[1] get max |0.2 k1 - 0.9 k3 + 0.8 k4 - 0.1 k5|
//      of Phi and T (the caller scales by tau/3).  partials holds 2 *
//      bt_rkm_num_blocks values.
//   K3 bt_rk4_full: one RK4 step, out = x + c6 (k1 + 2 k2 + 2 k3 + k4).
//      h = dt/2 and c6 = dt/6 as the host rounds them; d is the state's
//      Dirichlet value, and each stage's blend takes d (1 + its weight).
//   K6 bt_euler_steps: `steps` forward-Euler steps, each at Dirichlet value
//      d; a depth it is not built for returns cudaErrorInvalidValue.
//   K7 bt_si_prepare: r0 = b_F - A_F Phi and uterm = dt lap(U) of the
//      semi-implicit prepare; s gets the per-cell anisotropy map unless it
//      is null.
#define BT_RHS_ENTRIES(SFX, S)                                                        \
  int bt_blend_rhs_##SFX(const S* F0, const S* U0, const S* F1, const S* U1,         \
                         const S* F2, const S* U2, const S* F3, const S* U3,         \
                         int n_states, S w1, S w2, S w3, S* outF, S* outU, int ny,   \
                         int nx, S d, S fu, int is_euler, const PhysParams<Ar<S>>* P, \
                         cudaStream_t stream) {                                       \
    return blend_rhs<S>(F0, U0, F1, U1, F2, U2, F3, U3, n_states, w1, w2, w3, outF,  \
                        outU, ny, nx, d, fu, is_euler, bt::whole_grid<Ar<S>>(), P,   \
                        stream);                                                      \
  }                                                                                   \
  int bt_rk4_final_##SFX(const S* xF, const S* xU, const S* k1F, const S* k1U,       \
                         const S* k2F, const S* k2U, const S* k3F, const S* k3U,     \
                         S* outF, S* outU, int ny, int nx, S dt, S c6, S d, S fu,    \
                         const PhysParams<Ar<S>>* P, cudaStream_t stream) {          \
    return rk4_final<S>(xF, xU, k1F, k1U, k2F, k2U, k3F, k3U, outF, outU, ny, nx,    \
                        dt, c6, d, fu, bt::whole_grid<Ar<S>>(), P, stream);           \
  }                                                                                   \
  int bt_rkm_attempt_##SFX(const S* F, const S* U, S* outF, S* outU, S* partials,    \
                           S* err, int ny, int nx, S tau, S d, S fu,                 \
                           const PhysParams<Ar<S>>* P, cudaStream_t stream) {        \
    return rkm_attempt<S>(F, U, outF, outU, partials, err,                           \
                          bt::whole_apron<Ar<S>>(ny, nx), ny, nx, tau, d, fu, P,     \
                          stream);                                                    \
  }                                                                                   \
  int bt_rk4_full_##SFX(const S* F, const S* U, S* outF, S* outU, int ny, int nx,    \
                        S h, S dt, S c6, S d, S fu, const PhysParams<Ar<S>>* P,      \
                        cudaStream_t stream) {                                        \
    return rk4_full<S>(F, U, outF, outU, bt::whole_apron<Ar<S>>(ny, nx), ny, nx, h,  \
                       dt, c6, d, fu, P, stream);                                     \
  }                                                                                   \
  int bt_euler_steps_##SFX(const S* F, const S* U, S* outF, S* outU, int ny, int nx, \
                           int steps, S d, S fu, const PhysParams<Ar<S>>* P,         \
                           cudaStream_t stream) {                                     \
    return euler_steps<S>(F, U, outF, outU, bt::whole_apron<Ar<S>>(ny, nx), ny, nx,  \
                          steps, d, fu, P, stream);                                   \
  }                                                                                   \
  int bt_si_prepare_##SFX(const S* F, const S* U, S* r0, S* uterm, S* s, int ny,     \
                          int nx, const PhysParams<Ar<S>>* P, cudaStream_t stream) { \
    return si_prepare<S>(F, U, r0, uterm, s, ny, nx, bt::whole_grid<Ar<S>>(), P,     \
                         stream);                                                     \
  }

// The mesh kernels on a shard, at both field types.  `rows`/`cols` are a
// shard's ghosts, (2 sides, 2 fields, nx) and (2, 2, ny), null along an axis
// that is not sharded; `edges` has bit 0..3 set when the shard holds the
// grid's first row, last row, first column, last column.
//   K12.1 ghost gather bt_halo_edges: the blend's first and last rows into
//      rows, first and last columns into cols (each skipped if null).
//   K12.1 bt_blend_rhs_halo: K1 on a shard, in rhs mode (K12.1) or in euler
//      mode (K12.3).
//   K12.4 bt_rk4_final_halo: K4 on a shard, the halo that of the blend [x, k3]
//      with weights [1, dt].
//   K12.7 bt_si_prepare_halo: K7 on a shard, the halo that of (F, U).
//   K5 bt_rkm_final: a = {x, k1, k3, k4} with weights {1, w1, w2, w3} =
//      {1, tau/2, -3 tau/2, 2 tau}: outF/outU = x + c6 (k1 + 4 k4 + k5),
//      err as K2's; partials holds 2 * bt_stage_num_blocks values.  On the
//      whole grid: null ghosts and all four edge bits.
#define BT_MESH_ENTRIES(SFX, S)                                                          \
  int bt_halo_edges_##SFX(const S* F0, const S* U0, const S* F1, const S* U1,           \
                          const S* F2, const S* U2, const S* F3, const S* U3,           \
                          int n_states, S w1, S w2, S w3, S* rows, S* cols, int ny,     \
                          int nx, cudaStream_t stream) {                                 \
    return halo_edges<S>(F0, U0, F1, U1, F2, U2, F3, U3, n_states, w1, w2, w3, rows,    \
                         cols, ny, nx, stream);                                          \
  }                                                                                      \
  int bt_blend_rhs_halo_##SFX(const S* F0, const S* U0, const S* F1, const S* U1,       \
                              const S* F2, const S* U2, const S* F3, const S* U3,       \
                              int n_states, S w1, S w2, S w3, S* outF, S* outU, int ny, \
                              int nx, S d, S fu, int is_euler, const S* rows,           \
                              const S* cols, int edges, const PhysParams<Ar<S>>* P,     \
                              cudaStream_t stream) {                                     \
    return blend_rhs<S>(F0, U0, F1, U1, F2, U2, F3, U3, n_states, w1, w2, w3, outF,     \
                        outU, ny, nx, d, fu, is_euler, halo_of(rows, cols, edges), P,   \
                        stream);                                                         \
  }                                                                                      \
  int bt_si_prepare_halo_##SFX(const S* F, const S* U, S* r0, S* uterm, S* s, int ny,   \
                               int nx, const S* rows, const S* cols, int edges,         \
                               const PhysParams<Ar<S>>* P, cudaStream_t stream) {       \
    return si_prepare<S>(F, U, r0, uterm, s, ny, nx, halo_of(rows, cols, edges), P,     \
                         stream);                                                        \
  }                                                                                      \
  int bt_rk4_final_halo_##SFX(const S* xF, const S* xU, const S* k1F, const S* k1U,     \
                              const S* k2F, const S* k2U, const S* k3F, const S* k3U,   \
                              S* outF, S* outU, int ny, int nx, S dt, S c6, S d, S fu,  \
                              const S* rows, const S* cols, int edges,                  \
                              const PhysParams<Ar<S>>* P, cudaStream_t stream) {        \
    return rk4_final<S>(xF, xU, k1F, k1U, k2F, k2U, k3F, k3U, outF, outU, ny, nx, dt,   \
                        c6, d, fu, halo_of(rows, cols, edges), P, stream);               \
  }                                                                                      \
  int bt_rkm_final_##SFX(const S* xF, const S* xU, const S* k1F, const S* k1U,          \
                         const S* k3F, const S* k3U, const S* k4F, const S* k4U, S w1,  \
                         S w2, S w3, S c6, S* outF, S* outU, S* partials, S* err,       \
                         int ny, int nx, S d, S fu, const S* rows, const S* cols,       \
                         int edges, const PhysParams<Ar<S>>* P, cudaStream_t stream) {  \
    return rkm_final<S>(xF, xU, k1F, k1U, k3F, k3U, k4F, k4U, w1, w2, w3, c6, outF,     \
                        outU, partials, err, ny, nx, d, fu, halo_of(rows, cols, edges), \
                        P, stream);                                                      \
  }

// The tile kernels on a shard of the (ny, nx) grid holding rows [y0, y0 +
// ny_l) and columns [x0, x0 + nx_l), from its ghosts (bt::Apron):
//   float32, y-meshes (x0 = 0, nx_l = nx, `slabs` the ghost rows):
//     K12.2 bt_rkm_attempt_slabs (slabs 5 rows deep; partials holds 2 *
//     bt_rkm_num_blocks(ny_l, nx) values), K12.5 bt_euler_steps_slabs (slabs
//     of `steps` rows), K12.6 bt_rk4_full_slabs (slabs 4 rows deep);
//   float64, y, x and 2D meshes -- the K13 twins -- with `rows` (2, 2, A,
//     nx_l + 2A, or nx_l wide when x is not sharded) and `cols` (2, 2, ny_l,
//     A), each null along an axis that is not sharded:
//     bt_rkm_attempt_apron (A = 5; partials 2 * bt_rkm_num_blocks(ny_l,
//     nx_l)), bt_euler_steps_apron (A = steps, 4 or 8), bt_rk4_full_apron
//     (A = 4).
extern "C" {

BT_RHS_ENTRIES(f32, float)
BT_RHS_ENTRIES(f64, double)
BT_MESH_ENTRIES(f32, float)
BT_MESH_ENTRIES(f64, double)

int bt_rkm_attempt_slabs_f32(const float* F, const float* U, float* outF, float* outU,
                             float* partials, float* err, const float* slabs, int y0,
                             int ny_l, int ny, int nx, float tau, float d, float fu,
                             const PhysParams<float>* P, cudaStream_t stream) {
  return rkm_attempt<float>(F, U, outF, outU, partials, err,
                            apron_of<float>(slabs, nullptr, y0, ny_l, 0, nx), ny, nx, tau, d,
                            fu, P, stream);
}

int bt_euler_steps_slabs_f32(const float* F, const float* U, float* outF, float* outU,
                             const float* slabs, int y0, int ny_l, int ny, int nx,
                             int steps, float d, float fu, const PhysParams<float>* P,
                             cudaStream_t stream) {
  return euler_steps<float>(F, U, outF, outU, apron_of<float>(slabs, nullptr, y0, ny_l, 0, nx),
                            ny, nx, steps, d, fu, P, stream);
}

int bt_rk4_full_slabs_f32(const float* F, const float* U, float* outF, float* outU,
                          const float* slabs, int y0, int ny_l, int ny, int nx, float h,
                          float dt, float c6, float d, float fu, const PhysParams<float>* P,
                          cudaStream_t stream) {
  return rk4_full<float>(F, U, outF, outU, apron_of<float>(slabs, nullptr, y0, ny_l, 0, nx),
                         ny, nx, h, dt, c6, d, fu, P, stream);
}

int bt_rkm_attempt_apron_f64(const double* F, const double* U, double* outF, double* outU,
                             double* partials, double* err, const double* rows,
                             const double* cols, int y0, int ny_l, int x0, int nx_l, int ny,
                             int nx, double tau, double d, double fu,
                             const PhysParams<bt::Rn>* P, cudaStream_t stream) {
  return rkm_attempt<double>(F, U, outF, outU, partials, err,
                             apron_of<double>(rows, cols, y0, ny_l, x0, nx_l), ny, nx, tau, d,
                             fu, P, stream);
}

int bt_euler_steps_apron_f64(const double* F, const double* U, double* outF, double* outU,
                             const double* rows, const double* cols, int y0, int ny_l,
                             int x0, int nx_l, int ny, int nx, int steps, double d, double fu,
                             const PhysParams<bt::Rn>* P, cudaStream_t stream) {
  return euler_steps<double>(F, U, outF, outU, apron_of<double>(rows, cols, y0, ny_l, x0, nx_l),
                             ny, nx, steps, d, fu, P, stream);
}

int bt_rk4_full_apron_f64(const double* F, const double* U, double* outF, double* outU,
                          const double* rows, const double* cols, int y0, int ny_l, int x0,
                          int nx_l, int ny, int nx, double h, double dt, double c6, double d,
                          double fu, const PhysParams<bt::Rn>* P, cudaStream_t stream) {
  return rk4_full<double>(F, U, outF, outU, apron_of<double>(rows, cols, y0, ny_l, x0, nx_l),
                          ny, nx, h, dt, c6, d, fu, P, stream);
}

// Number of value pairs the K5 partials buffer holds (2 * this many values).
int bt_stage_num_blocks(int ny, int nx) {
  dim3 g = k1_grid(ny, nx);
  return int(g.x * g.y);
}

// Number of value pairs the K2 partials buffer holds (2 * this many values).
int bt_rkm_num_blocks(int ny, int nx) {
  dim3 g = tile_grid(ny, nx);
  return int(g.x * g.y);
}

// Dynamic shared memory of a tile kernel in bytes, for the build report:
// kernel 2 (K2), 3 (K3) or 6 (K6 at `steps` 4 or 8), float64 if f64 != 0;
// -1 for one that is not built.
int bt_tile_smem_bytes(int kernel, int steps, int f64) {
  using bt::Rn;
  if (kernel == 2)
    return f64 ? int(sizeof(bt::RkmSmem<Rn, bt::K2Block<Rn, false>::kThreads>))
               : int(sizeof(bt::RkmSmem<float, bt::K2Block<float, false>::kThreads>));
  if (kernel == 3) return f64 ? int(sizeof(bt::Rk4Smem<Rn>)) : int(sizeof(bt::Rk4Smem<float>));
  if (kernel == 6 && steps == 4)
    return f64 ? bt::euler_smem_bytes<Rn, 4>() : bt::euler_smem_bytes<float, 4>();
  if (kernel == 6 && steps == 8 && f64) return bt::euler_smem_bytes<Rn, 8>();
  return -1;
}

}  // extern "C"
