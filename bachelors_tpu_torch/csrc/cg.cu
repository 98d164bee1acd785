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
//     entry `update_xr_rr` :343) with the alpha the JAX loop forms before
//     it (`solvers/cg.py:112`): alpha = rr / (pAp < eps ? eps : pAp) from
//     the two device scalars, x += alpha p and r -= alpha Ap in place, and
//     <r', r'> of the new r.  Pointwise, so in place is safe.  Bound by
//     bytes: 4 fields read, 2 written, 1.88 us at float32 512^2 and 3.76 at
//     float64 (3.35 TB/s).  What held it back: two launches a call (the
//     update with one partial per 256-cell chunk, then the one-block sum
//     of the partials), and before them two eager torch ops of the loop
//     (a clamp and a division) that formed alpha, so three host
//     dispatches and four launches a CG iteration sat between K8 and the
//     host read.  Design: alpha formed in the kernel with the loop's
//     rounding (`div_rn`, the select keeping a NaN pAp as torch.clamp
//     does), one cell a thread in chunk order, and the sum finished in the
//     same launch as K8's (`matvec_pAp_kernel`): at most kSumThreads
//     blocks, block b adding chunks b, b + kSumThreads, ... into its lane,
//     the last block to draw the ticket adding the lanes by `lane_tree`.
//     That is the one-block sum's order, so x, r and <r', r'> keep the bits
//     of the two launches, and nothing runs between K8 and K9.  A block's
//     warps run through a pass of up to kK9Pass chunks without a barrier.
//     At 512^2, the semi-implicit path's size, a call takes 4.7 us on the
//     device against 6.7 for the two launches and the two ops; at float64
//     4096^2 it runs 4% slower than they do (PERF.md §6).
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
//     Bound by bytes: 2 fields read and 1 written in cross mode, 3 + 1 in
//     aniso, 4 + 1 in heat, 5 + 1 in heat with the extra terms (at float64
//     512^2 1.88, 2.50, 3.13 and 3.76 us at 3.35 TB/s).  Design: K8's
//     matvec, one thread per cell, without the dot product; in the cross
//     and heat modes a block whose cells and ring lie inside the fields
//     reads e's neighbours directly, the edge blocks through `cross_at`,
//     and the aniso mode keeps `cross_at` on every cell (see
//     si_residual_kernel).  The output must not overlap e, whose
//     neighbours it reads.
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
//     whole grid bit for bit.  Bound by bytes like K14 (0.94 us in cross
//     mode on a 256x512 shard at float64).  On a shard of 512^2 the launch
//     is 256-512 blocks, one partial wave whose edge blocks set the time,
//     and a launch that small takes ~1.3 us by graph replay on the H100
//     whatever it moves (K15.1 at 256^2, 0.79 MB, PERF.md §6), so the
//     interior blocks' direct reads take off a few percent at most.
//
// K12.8 over members bt_matvec_pAp_halo_members and K14's twin over
//     members bt_si_residual_halo_members: replace, under `jax.vmap` of the
//     semi-implicit step inside `shard_map` (`bachelors_tpu/parallel/
//     sharded.py:56-71`), `pallas_cg.py:cross_/aniso_matvec_pAp_sharded`
//     (:238, :249 -> `pallas_call` :185) and `pallas_dd.py:cross_/aniso_/
//     heat_residual_dd_sharded` (:1014, :1027, :1039 -> `pallas_call` :930).
//     K8 over members and K14 over members with each member's rows of
//     member-major ghosts (the gather over members of (p, p), of (e, e), at
//     stage 1, then the ring exchange): a member's A p, its shard-local
//     <p, A p> (K12.8's fixed order, so `pAp_in_kernel_order` reproduces
//     it) and its residual equal the single-shard K12.8's and K14 twin's bit
//     for bit.  The launch slots' lanes and tickets are K8 over members':
//     a launch over any subset of the members leaves every counter at 0.
//     Bound by bytes like K12.8 and the K14 twin, B times them.
//
// K8, K8b, K9, K10 and K14 over members: the same sites as `jax.vmap` of
//     the semi-implicit step runs them (K8b where it runs `cg_solve_fused`,
//     JAX's `solvers/semi_implicit.py:186-193`, :217-218), each
//     pallas_call's grid lifted by a leading member dimension.  Each
//     kernel's body runs unchanged on the (ny, nx) slice of the member its
//     blocks serve (physics.cuh: `Members`; y in K8's, K8b's, K9's and
//     K10's 1D grids, z in K14's 2D grid), so
//     a member's outputs and dot products equal the unbatched kernel's bit
//     for bit; the per-member scalars are (B,) device vectors indexed by
//     member id, and K8's and K9's lanes and ticket are one set per launch
//     slot.  One launch serves every member the CG loop still iterates,
//     which the host chooses each round.  Bound like the unbatched
//     kernels, B times the bytes.
//
// The partial sums are added in a fixed order, never by a library
// reduction: K8's, K12.8's, K8b's and K9's by their own last block, in the
// exact order of the one-block sum kernel each launched after it before,
// so a dot product has the bits it had as two launches.  Block sums run in
// a fixed tree order, so a result does not
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

// Each operation rounded on its own: cg.cu is built with FMA contraction.
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ---------------------------------------------------------------- K8 ----

// The tree of the one-block sum kernel that K8 and K9 each launched after
// their blocks before (block_sum<kSumThreads> over kSumThreads lane sums:
// warp shuffles, then over the warps), lanes[0:n] and 0
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
__device__ __forceinline__ void matvec_pAp_block(
    const Real* __restrict__ p, const Real* __restrict__ s, const Real* __restrict__ r,
    const Real* __restrict__ beta, Real* __restrict__ p_out, Real* __restrict__ out,
    Real* lanes, unsigned* ticket, Real* __restrict__ pAp_out, int ny, int nx, int tiles_x,
    int tiles, int bc, Real C, Real X, Real Y, const Halo<Real>& h) {
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

template <bool WITH_S, bool BLEND, class Real>
__global__ void __launch_bounds__(kCgThreads)
    matvec_pAp_kernel(const Real* __restrict__ p, const Real* __restrict__ s,
                      const Real* __restrict__ r, const Real* __restrict__ beta,
                      Real* __restrict__ p_out, Real* __restrict__ out, Real* lanes,
                      unsigned* ticket, Real* __restrict__ pAp_out, int ny, int nx,
                      int tiles_x, int tiles, int bc, Real C, Real X, Real Y, Halo<Real> h) {
  matvec_pAp_block<WITH_S, BLEND>(p, s, r, beta, p_out, out, lanes, ticket, pAp_out, ny, nx,
                                  tiles_x, tiles, bc, C, X, Y, h);
}

// K8 over members (physics.cuh: `Members`): blockIdx.y is the launch's
// member z, ensemble member id[z], whose blocks run K8's body on its own
// fields, p, s (aniso form) and out at id[z] * ny * nx, with launch slot
// z's lanes and ticket, `stride` values a slot (the unbatched kernel's
// buffer), and its <p, A p> into pAp[id[z]].  Each slot's counter wraps
// back to 0 with its member's last draw, so a launch over any subset of
// the members leaves every counter as it found it.  With member-major
// ghosts of (p, p) (h; whole_grid for K8), K12.8 over members on a shard:
// member id[z]'s blocks read its rows of the ghosts (`member_halo`) and
// sum its shard-local <p, A p> in K12.8's order.
//
// BLEND: K8b over members, the same body reading p' = r + beta p of its
// member (r and p_out at the member's offset too), beta = rr_new[id] /
// (rr[id] < eps ? eps : rr[id]) formed by each block from the two (B,)
// <r, r> vectors, rounded as the single fused loop's two torch ops
// (`div_rn`, the select keeping a NaN rr as torch.clamp does), as K10 over
// members forms it.  So p', A p' and <p', A p'> equal the single K8b's
// launched with that loop's beta, bit for bit.
template <bool WITH_S, bool BLEND, class Real>
__global__ void __launch_bounds__(kCgThreads)
    matvec_pAp_members_kernel(const Real* __restrict__ p, const Real* __restrict__ s,
                              const Real* __restrict__ r, const Real* __restrict__ rr_new,
                              const Real* __restrict__ rr, Real eps, Real* __restrict__ p_out,
                              Real* __restrict__ out, Real* partials, Real* __restrict__ pAp,
                              int ny, int nx, int tiles_x, int tiles, int stride, int bc,
                              Real C, Real X, Real Y, Halo<Real> h,
                              const __grid_constant__ Members<Real> m) {
  const int id = m.id[blockIdx.y];
  const size_t off = member_offset(m, blockIdx.y, ny, nx);
  Real* lanes = partials + size_t(blockIdx.y) * size_t(stride);
  unsigned* ticket = reinterpret_cast<unsigned*>(lanes + stride - 1);
  Real beta = Real(0);
  if (BLEND) beta = div_rn(rr_new[id], rr[id] < eps ? eps : rr[id]);
  matvec_pAp_block<WITH_S, BLEND, Real>(p + off, WITH_S ? s + off : nullptr,
                                        BLEND ? r + off : nullptr, &beta,
                                        BLEND ? p_out + off : nullptr, out + off, lanes, ticket,
                                        pAp + id, ny, nx, tiles_x, tiles, bc, C, X, Y,
                                        member_halo(h, id, ny, nx));
}

// ---------------------------------------------------------------- K9 ----

// Chunks of a block's pass of K9: their warp sums wait in shared memory,
// and the block meets at one barrier a pass, not one a chunk.
constexpr int kK9Pass = 64;
static_assert(kK9Pass <= kCgThreads, "one thread a chunk forms the pass's partials");

// x += a p and r -= a Ap for the n cells, a = *rr / max(*pAp, eps), and
// <r', r'> into *rr_out, in the order of the one-block sum launch this
// kernel replaces: chunks of kCgThreads cells, each summed by block_sum
// into a partial; lane L of kSumThreads adding partials L, L + kSumThreads,
// ... from 0; then the lanes' tree.  The grid is min(chunks, kSumThreads)
// blocks and block b takes chunks b, b + kSumThreads, ...: lane b's
// partials.  Each warp runs through up to kK9Pass of them without a
// barrier, keeping each chunk's shuffle sum (block_sum's first stage);
// then each chunk's partial is block_sum's second stage over its eight
// warp sums, ((w0 + w4) + (w2 + w6)) + ((w1 + w5) + (w3 + w7)) (the lanes
// past them add 0, and a square is never -0), and thread 0 adds the
// partials into lane b in chunk order.  The ticket as K8's: the block that
// draws the last one adds the lanes into *rr_out.  The update keeps the
// two launches' expressions, contracted to the same FMAs, so x and r keep
// their bits too.
template <class Real>
__device__ __forceinline__ void update_xr_rr_block(
    Real* __restrict__ x, Real* __restrict__ r, const Real* __restrict__ p,
    const Real* __restrict__ Ap, const Real* __restrict__ rr, const Real* __restrict__ pAp,
    Real eps, Real* lanes, unsigned* ticket, Real* __restrict__ rr_out, int n, int chunks) {
  constexpr int kWarps = kCgThreads / 32;
  __shared__ Real warp_sums[kK9Pass][kWarps];
  __shared__ Real partials[kK9Pass];
  __shared__ Real red[kSumThreads / 32];  // the lanes' tree
  __shared__ bool last;
  const Real den = *pAp < eps ? eps : *pAp;  // a NaN pAp stays NaN, as torch.clamp keeps it
  const Real a = div_rn(*rr, den);
  const int warp = threadIdx.x >> 5;
  Real lane = Real(0);  // in thread 0
  for (int k0 = blockIdx.x; k0 < chunks; k0 += kK9Pass * kSumThreads) {
    const int left = (chunks - 1 - k0) / kSumThreads + 1;
    const int m = left < kK9Pass ? left : kK9Pass;  // this pass's chunks
    for (int q = 0; q < m; ++q) {
      const int c = (k0 + q * kSumThreads) * kCgThreads + threadIdx.x;
      Real v = Real(0);
      if (c < n) {
        x[c] = x[c] + a * p[c];
        const Real rn = r[c] - a * Ap[c];
        r[c] = rn;
        v = rn * rn;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) warp_sums[q][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < m) {
      const Real* w = warp_sums[threadIdx.x];
      partials[threadIdx.x] = ((w[0] + w[4]) + (w[2] + w[6])) + ((w[1] + w[5]) + (w[3] + w[7]));
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int q = 0; q < m; ++q) lane += partials[q];
  }
  if (threadIdx.x == 0) {
    lanes[blockIdx.x] = lane;
    fence_acq_rel_gpu();  // releases the lane with the ticket
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
    if (last) fence_acq_rel_gpu();  // acquires every block's lane
  }
  __syncthreads();
  if (last) {
    const Real sum = lane_tree(lanes, int(gridDim.x), red);
    if (threadIdx.x == 0) *rr_out = sum;
  }
}

template <class Real>
__global__ void __launch_bounds__(kCgThreads)
    update_xr_rr_kernel(Real* __restrict__ x, Real* __restrict__ r,
                        const Real* __restrict__ p, const Real* __restrict__ Ap,
                        const Real* __restrict__ rr, const Real* __restrict__ pAp, Real eps,
                        Real* lanes, unsigned* ticket, Real* __restrict__ rr_out, int n,
                        int chunks) {
  update_xr_rr_block(x, r, p, Ap, rr, pAp, eps, lanes, ticket, rr_out, n, chunks);
}

// K9 over members: blockIdx.y is launch member z (ensemble member id[z]),
// its blocks K9's body on its own x, r, p and Ap, alpha from rr[id[z]] and
// pAp[id[z]], <r', r'> into rr_out[id[z]], slot z's lanes and ticket as
// K8's over members.
template <class Real>
__global__ void __launch_bounds__(kCgThreads)
    update_xr_rr_members_kernel(Real* __restrict__ x, Real* __restrict__ r,
                                const Real* __restrict__ p, const Real* __restrict__ Ap,
                                const Real* __restrict__ rr, const Real* __restrict__ pAp,
                                Real eps, Real* partials, int stride,
                                Real* __restrict__ rr_out, int ny, int nx, int chunks,
                                const __grid_constant__ Members<Real> m) {
  const int id = m.id[blockIdx.y];
  const size_t off = member_offset(m, blockIdx.y, ny, nx);
  Real* lanes = partials + size_t(blockIdx.y) * size_t(stride);
  unsigned* ticket = reinterpret_cast<unsigned*>(lanes + stride - 1);
  update_xr_rr_block(x + off, r + off, p + off, Ap + off, rr + id, pAp + id, eps, lanes, ticket,
                     rr_out + id, ny * nx, chunks);
}

// --------------------------------------------------------------- K10 ----

// W values of 16 bytes, loaded and stored at once
template <class Real, int W>
struct alignas(sizeof(Real) * W) Pack {
  Real v[W];
};

// p[c] = r[c] + beta p[c] for W cells per thread (W = 1: one cell)
template <int W, class Real>
__device__ __forceinline__ void advance_p_block(const Real* __restrict__ r,
                                                Real* __restrict__ p,
                                                const Real* __restrict__ rr_new,
                                                const Real* __restrict__ rr, Real eps, int n) {
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

template <int W, class Real>
__global__ void __launch_bounds__(kCgThreads)
    advance_p_kernel(const Real* __restrict__ r, Real* __restrict__ p,
                     const Real* __restrict__ rr_new, const Real* __restrict__ rr, Real eps,
                     int n) {
  advance_p_block<W>(r, p, rr_new, rr, eps, n);
}

// K10 over members: blockIdx.y is launch member z (ensemble member id[z]),
// its blocks K10's body on its own r and p, beta from rr_new[id[z]] and
// rr[id[z]].
template <int W, class Real>
__global__ void __launch_bounds__(kCgThreads)
    advance_p_members_kernel(const Real* __restrict__ r, Real* __restrict__ p,
                             const Real* __restrict__ rr_new, const Real* __restrict__ rr,
                             Real eps, int ny, int nx,
                             const __grid_constant__ Members<Real> m) {
  const int id = m.id[blockIdx.y];
  const size_t off = member_offset(m, blockIdx.y, ny, nx);
  advance_p_block<W>(r + off, p + off, rr_new + id, rr + id, eps, ny * nx);
}

// --------------------------------------------------------------- K14 ----

constexpr int kResCross = 0;
constexpr int kResAniso = 1;
constexpr int kResHeat = 2;
constexpr int kResHeatExtra = 3;

// a: the map s (aniso) or e1_F (heat); b: e2_F (heat); x: the extra heat
// terms (heat + extra)
// On the whole grid (h = whole_grid) or, with a halo (field 0 of its ghosts
// is e's), the K14 twin on a shard.  A block whose cells and ring lie
// inside the fields (`inner_block`, physics.cuh) reads e's four neighbours
// directly; the others keep `cross_at` with the halo and the Dirichlet
// image -e; both feed one body, so every cell runs the same operations on
// the same values as before, with the same contractions.  The aniso mode
// keeps the edge rule on every cell: with the interior branch it ran
// 3.4-4.0% slower on a 512x256 shard (H100, PERF.md §6).
template <int MODE, class Real>
__device__ __forceinline__ void si_residual_block(
    const Real* __restrict__ e, const Real* __restrict__ r0, const Real* __restrict__ a,
    const Real* __restrict__ b, const Real* __restrict__ x, Real* __restrict__ out, int ny,
    int nx, int bc, Real C, Real X, Real Y, Real L, const Halo<Real>& h) {
  const int i0 = blockIdx.y * kCgBlockY, j0 = blockIdx.x * kCgBlockX;
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  const bool inner = MODE != kResAniso && inner_block<kCgBlockY, kCgBlockX>(i0, j0, ny, nx);
  if (!inner && (i >= ny || j >= nx)) return;
  const int c = i * nx + j;
  const Real ec = e[c];
  Cross<Real> n;
  if (inner)
    n = {e[c + nx], e[c - nx], e[c + 1], e[c - 1]};
  else
    n = cross_at(Load<Real>{e}, bc, 0, ec, Real(0), h, i, j, ny, nx);
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

template <int MODE, class Real>
__global__ void __launch_bounds__(kCgThreads)
    si_residual_kernel(const Real* __restrict__ e, const Real* __restrict__ r0,
                       const Real* __restrict__ a, const Real* __restrict__ b,
                       const Real* __restrict__ x, Real* __restrict__ out, int ny, int nx,
                       int bc, Real C, Real X, Real Y, Real L, Halo<Real> h) {
  si_residual_block<MODE>(e, r0, a, b, x, out, ny, nx, bc, C, X, Y, L, h);
}

// K14 over members: blockIdx.z is launch member z (ensemble member id[z]),
// its blocks K14's body on its own e, r0, a, b, x and out (the planes its
// mode reads).  With member-major ghosts of (e, e) (h; whole_grid for K14),
// K14's twin over members on a shard, each member reading its rows of them.
template <int MODE, class Real>
__global__ void __launch_bounds__(kCgThreads)
    si_residual_members_kernel(const Real* __restrict__ e, const Real* __restrict__ r0,
                               const Real* __restrict__ a, const Real* __restrict__ b,
                               const Real* __restrict__ x, Real* __restrict__ out, int ny,
                               int nx, int bc, Real C, Real X, Real Y, Real L, Halo<Real> h,
                               const __grid_constant__ Members<Real> m) {
  const size_t off = member_offset(m, blockIdx.z, ny, nx);
  si_residual_block<MODE>(e + off, r0 + off, a != nullptr ? a + off : nullptr,
                          b != nullptr ? b + off : nullptr, x != nullptr ? x + off : nullptr,
                          out + off, ny, nx, bc, C, X, Y, L,
                          member_halo(h, m.id[blockIdx.z], ny, nx));
}

// ------------------------------------------------------------ launches ----

inline dim3 matvec_grid(int ny, int nx) {
  return dim3((nx + kCgBlockX - 1) / kCgBlockX, (ny + kCgBlockY - 1) / kCgBlockY);
}

inline int pointwise_blocks(int n) { return (n + kCgThreads - 1) / kCgThreads; }

// Values past which K8's and K9's lanes never reach for a (ny, nx) field:
// K8's 8x32 tiles, at least as many as K9's 256-cell chunks; their ticket
// counter sits in the slot after them (`bt_cg_num_partials` counts it).
inline int cg_partials(int ny, int nx) {
  const dim3 g = matvec_grid(ny, nx);
  return int(g.x * g.y);
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

// K9: its lanes and ticket in `partials`, as K8's
template <class Real>
int update_xr_rr(Real* x, Real* r, const Real* p, const Real* Ap, const Real* rr,
                 const Real* pAp, Real eps, Real* partials, Real* rr_out, int ny, int nx,
                 cudaStream_t stream) {
  const int n = ny * nx, chunks = pointwise_blocks(n);
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + cg_partials(ny, nx));
  update_xr_rr_kernel<<<chunks < kSumThreads ? chunks : kSumThreads, kCgThreads, 0, stream>>>(
      x, r, p, Ap, rr, pAp, eps, partials, ticket, rr_out, n, chunks);
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

// ------------------------------------------------------- over members ----
// The launches of K8, K9, K10 and K14 over the members m.id[0..count) of
// stacked (B, ny, nx) fields: the unbatched grid, its y (K8, K9, K10) or z
// (K14) the launch's members.  K8's and K9's partials hold `count` slots
// of bt_cg_num_partials(ny, nx) values, each slot's ticket zeroed once.

// K8 over members (r null) or K8b over members (r, rr_new, rr and p_out
// given); with member-major ghosts h (K8 only), K12.8 over members
template <class Real>
int matvec_pAp_members(const Real* p, const Real* s, const Real* r, const Real* rr_new,
                       const Real* rr, Real eps, Real* p_out, Real* out, Real* partials,
                       Real* pAp, int ny, int nx, int bc, Real C, Real X, Real Y, Halo<Real> h,
                       const Members<Real>* m, int count, cudaStream_t stream) {
  if (!members_ok(count)) return int(cudaErrorInvalidValue);
  const dim3 g = matvec_grid(ny, nx);
  const int tiles = int(g.x * g.y), stride = cg_partials(ny, nx) + 1;
  const dim3 grid(tiles < kSumThreads ? tiles : kSumThreads, count), block(kCgBlockX, kCgBlockY);
#define BT_MATVEC_MEMBERS(WS, BL)                                                             \
  matvec_pAp_members_kernel<WS, BL><<<grid, block, 0, stream>>>(                              \
      p, s, r, rr_new, rr, eps, p_out, out, partials, pAp, ny, nx, int(g.x), tiles, stride, bc, \
      C, X, Y, h, *m)
  if (r != nullptr) {
    if (s != nullptr)
      BT_MATVEC_MEMBERS(true, true);
    else
      BT_MATVEC_MEMBERS(false, true);
  } else if (s != nullptr) {
    BT_MATVEC_MEMBERS(true, false);
  } else {
    BT_MATVEC_MEMBERS(false, false);
  }
#undef BT_MATVEC_MEMBERS
  return int(cudaGetLastError());
}

template <class Real>
int update_xr_rr_members(Real* x, Real* r, const Real* p, const Real* Ap, const Real* rr,
                         const Real* pAp, Real eps, Real* partials, Real* rr_out, int ny,
                         int nx, const Members<Real>* m, int count, cudaStream_t stream) {
  if (!members_ok(count)) return int(cudaErrorInvalidValue);
  const int chunks = pointwise_blocks(ny * nx), stride = cg_partials(ny, nx) + 1;
  const dim3 grid(chunks < kSumThreads ? chunks : kSumThreads, count);
  update_xr_rr_members_kernel<<<grid, kCgThreads, 0, stream>>>(
      x, r, p, Ap, rr, pAp, eps, partials, stride, rr_out, ny, nx, chunks, *m);
  return int(cudaGetLastError());
}

// 16-byte passes where every member's r and p start 16-byte aligned
template <class Real>
int advance_p_members(const Real* r, Real* p, const Real* rr_new, const Real* rr, Real eps,
                      int ny, int nx, const Members<Real>* m, int count, cudaStream_t stream) {
  if (!members_ok(count)) return int(cudaErrorInvalidValue);
  constexpr int W = 16 / int(sizeof(Real));
  const int n = ny * nx;
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(p)) % 16 == 0 &&
      size_t(n) * sizeof(Real) % 16 == 0)
    advance_p_members_kernel<W><<<dim3(pointwise_blocks((n + W - 1) / W), count), kCgThreads, 0,
                                  stream>>>(r, p, rr_new, rr, eps, ny, nx, *m);
  else
    advance_p_members_kernel<1><<<dim3(pointwise_blocks(n), count), kCgThreads, 0, stream>>>(
        r, p, rr_new, rr, eps, ny, nx, *m);
  return int(cudaGetLastError());
}

// K14 over members (h = whole_grid) or its twin over members on a shard
template <class Real>
int si_residual_members(const Real* e, const Real* r0, const Real* a, const Real* b,
                        const Real* x, Real* out, int ny, int nx, int bc, int mode, Real C,
                        Real X, Real Y, Real L, Halo<Real> h, const Members<Real>* m,
                        int count, cudaStream_t stream) {
  if (!members_ok(count)) return int(cudaErrorInvalidValue);
  dim3 grid = matvec_grid(ny, nx);
  grid.z = count;
  const dim3 block(kCgBlockX, kCgBlockY);
#define BT_RES_MEMBERS(MODE)                                                               \
  si_residual_members_kernel<MODE><<<grid, block, 0, stream>>>(e, r0, a, b, x, out, ny, nx, \
                                                               bc, C, X, Y, L, h, *m)
  switch (mode) {
    case kResCross: BT_RES_MEMBERS(kResCross); break;
    case kResAniso: BT_RES_MEMBERS(kResAniso); break;
    case kResHeat: BT_RES_MEMBERS(kResHeat); break;
    case kResHeatExtra: BT_RES_MEMBERS(kResHeatExtra); break;
    default:
      return int(cudaErrorInvalidValue);
  }
#undef BT_RES_MEMBERS
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
//   K9 bt_update_xr_rr: x += alpha p, r -= alpha Ap (in place, (ny, nx)
//      fields) with alpha = rr[0] / (pAp[0] < eps ? eps : pAp[0]), and
//      rr_out[0] = <r, r> of the new r; rr and pAp are device scalars,
//      rr_out another.  partials as K8's, shared with it on one stream.
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
  int bt_update_xr_rr_##SFX(S* x, S* r, const S* p, const S* Ap, const S* rr,        \
                            const S* pAp, S eps, S* partials, S* rr_out, int ny, int nx, \
                            cudaStream_t stream) {                                    \
    return bt::update_xr_rr<S>(x, r, p, Ap, rr, pAp, eps, partials, rr_out, ny, nx,  \
                               stream);                                               \
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

// K8, K9, K10 and K14 over the members of stacked (B, ny, nx) fields: `m`
// the launch's members (bt::Members, only its ids read), `count` of them,
// 1..bt_members_max().  Member id[z]'s rows are the unbatched entry's on
// its own fields; the per-member scalars are (B,) device vectors indexed
// by member id.
//   K8 bt_matvec_pAp_members: out = A p and pAp[id] = <p, A p> (s null:
//      the cross form; else the stacked maps); partials holds count *
//      bt_cg_num_partials(ny, nx) values, each slot's ticket zeroed once.
//   K8b bt_advance_p_matvec_members: p_out = p' = r + beta p of member id,
//      beta = rr_new[id] / (rr[id] < eps ? eps : rr[id]), out = A p' and
//      pAp[id] = <p', A p'>; partials as K8's, shared with it and K9 on one
//      stream.  p_out and out overlap none of r, p, s and each other.
//   K9 bt_update_xr_rr_members: x, r of member id with alpha = rr[id] /
//      (pAp[id] < eps ? eps : pAp[id]), rr_out[id] = <r', r'>; partials as
//      K8's, shared with it on one stream.
//   K10 bt_advance_p_members: p = r + beta p of member id, beta = rr_new[id]
//      / (rr[id] < eps ? eps : rr[id]).
//   K14 bt_si_residual_members: K14 in `mode` on each member's planes.
// On a shard of a mesh, with member-major ghosts rows (B, 2, 2, nx) and
// cols (B, 2, 2, ny) (null along an axis that is not sharded) and the
// shard's global edge bits, as K12.8's and the K14 twin's:
//   K12.8 bt_matvec_pAp_halo_members: K8 over members reading each member's
//      ghosts of (p, p); pAp[id] = the member's shard-local <p, A p>.
//   K14 twin bt_si_residual_halo_members: K14 over members reading each
//      member's ghosts of (e, e).
#define BT_CG_MEMBERS_ENTRIES(SFX, S)                                                  \
  int bt_matvec_pAp_members_##SFX(const S* p, const S* s, S* out, S* partials, S* pAp, \
                                  int ny, int nx, int bc, S C, S X, S Y,              \
                                  const bt::Members<S>* m, int count,                 \
                                  cudaStream_t stream) {                              \
    return bt::matvec_pAp_members<S>(p, s, nullptr, nullptr, nullptr, S(0), nullptr, out, \
                                     partials, pAp, ny, nx, bc, C, X, Y,              \
                                     bt::whole_grid<S>(), m, count, stream);          \
  }                                                                                    \
  int bt_advance_p_matvec_members_##SFX(const S* r, const S* p, const S* s,            \
                                        const S* rr_new, const S* rr, S eps,           \
                                        S* p_out, S* out, S* partials, S* pAp, int ny, \
                                        int nx, int bc, S C, S X, S Y,                 \
                                        const bt::Members<S>* m, int count,            \
                                        cudaStream_t stream) {                         \
    return bt::matvec_pAp_members<S>(p, s, r, rr_new, rr, eps, p_out, out, partials,  \
                                     pAp, ny, nx, bc, C, X, Y, bt::whole_grid<S>(), m, \
                                     count, stream);                                  \
  }                                                                                    \
  int bt_update_xr_rr_members_##SFX(S* x, S* r, const S* p, const S* Ap, const S* rr, \
                                    const S* pAp, S eps, S* partials, S* rr_out,      \
                                    int ny, int nx, const bt::Members<S>* m,          \
                                    int count, cudaStream_t stream) {                 \
    return bt::update_xr_rr_members<S>(x, r, p, Ap, rr, pAp, eps, partials, rr_out,   \
                                       ny, nx, m, count, stream);                     \
  }                                                                                    \
  int bt_advance_p_members_##SFX(const S* r, S* p, const S* rr_new, const S* rr,      \
                                 S eps, int ny, int nx, const bt::Members<S>* m,      \
                                 int count, cudaStream_t stream) {                    \
    return bt::advance_p_members<S>(r, p, rr_new, rr, eps, ny, nx, m, count, stream); \
  }                                                                                    \
  int bt_si_residual_members_##SFX(const S* e, const S* r0, const S* a, const S* b,   \
                                   const S* x, S* out, int ny, int nx, int bc,        \
                                   int mode, S C, S X, S Y, S L,                      \
                                   const bt::Members<S>* m, int count,                \
                                   cudaStream_t stream) {                             \
    return bt::si_residual_members<S>(e, r0, a, b, x, out, ny, nx, bc, mode, C, X, Y, \
                                      L, bt::whole_grid<S>(), m, count, stream);      \
  }                                                                                    \
  int bt_matvec_pAp_halo_members_##SFX(const S* p, const S* s, S* out, S* partials,    \
                                       S* pAp, int ny, int nx, int bc, S C, S X, S Y,  \
                                       const S* rows, const S* cols, int edges,        \
                                       const bt::Members<S>* m, int count,             \
                                       cudaStream_t stream) {                          \
    return bt::matvec_pAp_members<S>(p, s, nullptr, nullptr, nullptr, S(0), nullptr, out, \
                                     partials, pAp, ny, nx, bc, C, X, Y,              \
                                     bt::Halo<S>{rows, cols, edges}, m, count, stream); \
  }                                                                                    \
  int bt_si_residual_halo_members_##SFX(const S* e, const S* r0, const S* a,           \
                                        const S* b, const S* x, S* out, int ny, int nx, \
                                        int bc, int mode, S C, S X, S Y, S L,          \
                                        const S* rows, const S* cols, int edges,       \
                                        const bt::Members<S>* m, int count,            \
                                        cudaStream_t stream) {                         \
    return bt::si_residual_members<S>(e, r0, a, b, x, out, ny, nx, bc, mode, C, X, Y, \
                                      L, bt::Halo<S>{rows, cols, edges}, m, count,    \
                                      stream);                                        \
  }

extern "C" {

// Values the partials buffer of K8 and K9 must hold for a (ny, nx) field:
// their lanes, then one slot whose first 4 bytes are their ticket counter,
// which must be zeroed once, when the buffer is allocated.
int bt_cg_num_partials(int ny, int nx) { return bt::cg_partials(ny, nx) + 1; }

BT_CG_ENTRIES(f32, float)
BT_CG_ENTRIES(f64, double)
BT_CG_MEMBERS_ENTRIES(f32, float)
BT_CG_MEMBERS_ENTRIES(f64, double)

}  // extern "C"
