// Physics body and boundary rule shared by the port's CUDA kernels.
//
// The counterpart of `bachelors_tpu/ops/pallas_rhs.py:_make_physics` (:220),
// written with the arithmetic of the plain version
// `bachelors_tpu_torch/models/allen_cahn.py:rhs_padded`: g(theta) comes from
// atan2f/cosf, as the oracle has it, so the integer-m0 recurrence
// `_g_theta_vpu` (:199) and its gate on m0 are gone.  Built without
// --use_fast_math: atan2f, cosf, sqrtf and the division are the accurate
// versions.  rhs.cu is built with -fmad=false (ops/cuda_build.py), so nvcc
// contracts no float mul+add into an FMA there: the float32 kernels round
// every operation as the plain version does on the card, where a whole
// Merson attempt on stiff fields amplified the two roundings' difference
// to 2.7e-5 of scale (tools/margins.py).  cg.cu, which includes this file
// too, keeps its contractions.
//
// Everything here is a template on the arithmetic type Real: `float` for
// the float32 kernels, `Rn` (below) for the float64 ones.  The float code
// is the same code with Real = float, literal for literal.
//
// Layout: fields are (ny, nx), row-major, y on axis 0.  N is row i+1, S is
// row i-1, E is column j+1, W is column j-1.
#pragma once

#include <cuda_runtime.h>

namespace bt {

// A double rounded at every operation, in the order the source writes
// (`__dadd_rn`/`__dmul_rn`, which nvcc never contracts into an FMA).  The
// float64 kernels compute in it so that they round as the plain torch
// version does, one elementwise operation at a time.  That matters under
// `f32_transcendentals` (the default): the gradient is rounded to float
// there, and a one-ulp double difference upstream would now and then round
// it the other way, moving g(theta) and |grad Phi| by a float ulp (~6e-8),
// far outside a float64 tolerance.  Same layout as a double: device memory
// holds plain doubles.
struct Rn {
  double v;
  Rn() = default;
  __host__ __device__ constexpr Rn(double x) : v(x) {}
};

__device__ __forceinline__ Rn operator+(Rn a, Rn b) { return __dadd_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator-(Rn a, Rn b) { return __dsub_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator*(Rn a, Rn b) { return __dmul_rn(a.v, b.v); }
__device__ __forceinline__ Rn operator/(Rn a, Rn b) { return __ddiv_rn(a.v, b.v); }
__device__ __forceinline__ bool operator==(Rn a, Rn b) { return a.v == b.v; }
__device__ __forceinline__ bool operator!=(Rn a, Rn b) { return a.v != b.v; }
__device__ __forceinline__ bool operator>(Rn a, Rn b) { return a.v > b.v; }

__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ Rn abs_of(Rn a) { return fabs(a.v); }

// BoundaryType, as numbered by ops/cuda_rhs.py
enum Bc : int { kPeriodic = 0, kNeumann = 1, kDirichlet = 2 };

// Coefficients of one configuration, computed on the host in double: the
// float32 kernels take them rounded to float once (as the JAX package
// rounds its Python-float constants against float32 arrays), the float64
// kernels as Python computes them.  Mirrored by ops/cuda_rhs.py:_Phys and
// _Phys64.
template <class Real>
struct PhysParams {
  Real inv_2dx, inv_2dy, inv_dx2, inv_dy2;
  Real k0_factor, k1_factor, k2_factor;
  Real dt, dt_L, L, Tm;
  Real S, m0, theta0;
  Real gamma;  // the semi-implicit scheme's implicitness blend
  int f_bc, u_bc;
  int corrector_guess;
  int f32_transcendentals;  // float64 only: atan2, cos and sqrt in float
};

// The image of centre value `c` across a Neumann or Dirichlet edge.
template <class Real>
__device__ __forceinline__ Real edge_image(int bc, Real c, Real d) {
  return bc == kNeumann ? c : Real(2) * d - c;
}

// Neighbour value in an apron tile as the padded field holds it (K2, K3, K6
// and their slab twins).  `cross` says that the step
// from the cell to this neighbour crosses a domain edge.  A periodic field
// reads the wrapped neighbour `nb`; Neumann clamps to the cell's own value;
// Dirichlet mirrors it through d: 2*d - centre (core/boundary.py:pad2).
template <class Real>
__device__ __forceinline__ Real neighbour(int bc, bool cross, Real nb, Real centre,
                                          Real d) {
  if (!cross || bc == kPeriodic) return nb;
  return edge_image(bc, centre, d);
}

// What a shard of a mesh sees beyond its edges (K5 on a mesh, K12.1, K12.3,
// K12.4, K12.7, K12.8): ghost rows below row 0 (side 0) and above row ny-1
// (side 1), ghost columns west of column 0 (side 0) and east of column nx-1
// (side 1), each (2 sides, 2 fields, n) with Phi before T; null along an
// axis that is not sharded.  `edges` has a bit for each global domain edge
// the shard holds.  Across one a Neumann or Dirichlet field takes its image
// and ignores the ghost; a periodic field reads the ghost, which the ring
// exchange filled from the other side of the domain.  The whole grid is the
// halo {null, null, kAllEdges}: the single-device kernels' own rule.
enum : int { kEdgeS = 1, kEdgeN = 2, kEdgeW = 4, kEdgeE = 8, kAllEdges = 15 };

template <class Real>
struct Halo {
  const Real* rows;
  const Real* cols;
  int edges;
};

template <class Real>
__host__ __device__ __forceinline__ Halo<Real> whole_grid() {
  return Halo<Real>{nullptr, nullptr, kAllEdges};
}

// The four neighbours of cell (i, j) of a (ny, nx) shard of field f (0: Phi,
// 1: T) whose own value is c, as the padded field holds them: `at(idx)` is
// the shard's value at flat index idx (a load, or K1's blend of states);
// across an edge a periodic field reads the wrapped cell or the ghost, a
// Neumann or Dirichlet field at a global edge its image at value d, and at a
// seam the ghost.  Only a value that the rule reads is touched.
template <class Real>
struct Cross {
  Real N, S, E, W;
};

template <class Real, class At>
__device__ __forceinline__ Cross<Real> cross_at(const At& at, int bc, int f, Real c, Real d,
                                                const Halo<Real>& h, int i, int j, int ny,
                                                int nx) {
  // `cross`: the step leaves the shard on `side` of `ghost` (n per side and
  // field, at position g), over global edge `bit` if the shard holds it
  auto nb = [&](bool cross, const Real* ghost, int n, int side, int bit, int g,
                int idx) -> Real {
    if (cross) {
      if (bc != kPeriodic && (ghost == nullptr || (h.edges & bit)))
        return edge_image(bc, c, d);
      if (ghost != nullptr) return ghost[(side * 2 + f) * n + g];
    }
    return at(idx);
  };
  const bool cN = i + 1 == ny, cS = i == 0, cE = j + 1 == nx, cW = j == 0;
  const int row = i * nx;
  Cross<Real> n;
  n.N = nb(cN, h.rows, nx, 1, kEdgeN, j, (cN ? 0 : i + 1) * nx + j);
  n.S = nb(cS, h.rows, nx, 0, kEdgeS, j, (cS ? ny - 1 : i - 1) * nx + j);
  n.E = nb(cE, h.cols, ny, 1, kEdgeE, i, row + (cE ? 0 : j + 1));
  n.W = nb(cW, h.cols, ny, 0, kEdgeW, i, row + (cW ? nx - 1 : j - 1));
  return n;
}

// Whether a block of BY x BX threads, one cell each, whose first cell is
// (i0, j0), lies with its one-cell ring inside the (ny, nx) fields (a test
// uniform over the block): no neighbour of its cells crosses a shard's or
// the domain's edge, so each is the field's own cell, read without
// `cross_at`'s edge rule, and the block holds no edge cell and no thread
// past the fields.  K1, K4, K5 and K7 (rhs.cu) and K14 (cg.cu) share it.
template <int BY, int BX>
__device__ __forceinline__ bool inner_block(int i0, int j0, int ny, int nx) {
  return i0 >= 1 && i0 + BY < ny && j0 >= 1 && j0 + BX < nx;
}

// `cross_at`'s reader of a field held in device memory.
template <class Real>
struct Load {
  const Real* A;
  __device__ __forceinline__ Real operator()(int idx) const { return A[idx]; }
};

// g(theta) = 1 - S cos(m0 theta + theta0) and |grad Phi| from the central
// differences; atan2(0, 0) = 0 and |grad| = 0 there
// (models/allen_cahn.py:_anisotropy).
__device__ __forceinline__ void anisotropy(const PhysParams<float>& P, float gx,
                                           float gy, float& g, float& norm) {
  float r2 = gx * gx + gy * gy;
  bool zero = r2 == 0.0f;
  float theta = atan2f(gy, zero ? 1.0f : gx);
  g = 1.0f - P.S * cosf(P.m0 * theta + P.theta0);
  norm = zero ? 0.0f : sqrtf(r2);
}

// The same at float64.  With f32_transcendentals (`simulation.cu:14-17`) the
// gradient is rounded to float and r2, atan2, cos, g and sqrt are evaluated
// in float, one correctly rounded operation at a time as the plain version's
// float32 tensor ops are (`__fmul_rn`/`__fadd_rn`: no FMA), then widened.
__device__ __forceinline__ void anisotropy(const PhysParams<Rn>& P, Rn gx, Rn gy,
                                           Rn& g, Rn& norm) {
  if (P.f32_transcendentals) {
    const float x = float(gx.v), y = float(gy.v);
    const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    const bool zero = r2 == 0.0f;
    const float theta = atan2f(y, zero ? 1.0f : x);
    const float arg = __fadd_rn(__fmul_rn(float(P.m0.v), theta), float(P.theta0.v));
    g = double(__fsub_rn(1.0f, __fmul_rn(float(P.S.v), cosf(arg))));
    norm = zero ? 0.0 : double(sqrtf(r2));
  } else {
    const Rn r2 = gx * gx + gy * gy;
    const bool zero = r2 == Rn(0);
    const Rn theta = atan2(gy.v, zero ? 1.0 : gx.v);
    g = Rn(1) - P.S * Rn(cos((P.m0 * theta + P.theta0).v));
    norm = zero ? 0.0 : sqrt(r2.v);
  }
}

// |grad Phi| alone, as `anisotropy` computes it: what an isotropic
// configuration (S = 0) needs, where g = 1 - 0 cos(.) is exactly 1 for any
// finite angle (and a NaN angle comes from a NaN gradient, which makes
// |grad Phi|, so dPhi/dt, NaN all the same).
__device__ __forceinline__ float grad_norm(const PhysParams<float>&, float gx, float gy) {
  float r2 = gx * gx + gy * gy;
  return r2 == 0.0f ? 0.0f : sqrtf(r2);
}

__device__ __forceinline__ Rn grad_norm(const PhysParams<Rn>& P, Rn gx, Rn gy) {
  if (P.f32_transcendentals) {
    const float x = float(gx.v), y = float(gy.v);
    const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    return r2 == 0.0f ? 0.0 : double(sqrtf(r2));
  }
  const Rn r2 = gx * gx + gy * gy;
  return r2 == Rn(0) ? 0.0 : sqrt(r2.v);
}

// g(theta) and |grad Phi| from the central differences (gx, gy).  ISO: the
// caller knows S = 0, so g = 1 without atan2 and cos (`grad_norm`); every
// product by g then keeps its bits, because a product by an exact 1 is
// exact.
template <bool ISO, class Real>
__device__ __forceinline__ void g_and_norm(const PhysParams<Real>& P, Real gx, Real gy, Real& g,
                                           Real& norm) {
  if constexpr (ISO) {
    g = Real(1);
    norm = grad_norm(P, gx, gy);
  } else {
    anisotropy(P, gx, gy, g, norm);
  }
}

// (dPhi/dt, dT/dt) at one cell from its own and its four neighbours'
// values (`simulation.cu:201-230`).  ISO: the isotropic instantiation
// (`g_and_norm`), bit for bit the same result at S = 0.
template <bool ISO = false, class Real>
__device__ __forceinline__ void physics(const PhysParams<Real>& P, Real Fc, Real FN,
                                        Real FS, Real FE, Real FW, Real Uc, Real UN,
                                        Real US, Real UE, Real UW, Real fu, Real& dF,
                                        Real& dU) {
  Real g, norm;
  g_and_norm<ISO>(P, (FE - FW) * P.inv_2dx, (FN - FS) * P.inv_2dy, g, norm);

  Real lapF = (FW - Real(2) * Fc + FE) * P.inv_dx2 + (FS - Real(2) * Fc + FN) * P.inv_dy2;
  Real lapU = (UW - Real(2) * Uc + UE) * P.inv_dx2 + (US - Real(2) * Uc + UN) * P.inv_dy2;

  Real k0 = g * (Fc * (Real(1) - Fc) * (Fc - Real(0.5))) * P.k0_factor;
  Real k2 = norm * P.k2_factor;
  Real k1 = g * P.k1_factor;

  if (P.corrector_guess) {
    Real corr = Real(1) + k2 * P.dt_L;
    dF = (k1 * lapF + k0 - k2 * (Uc - P.Tm + P.dt * lapU)) / corr;
  } else {
    dF = k1 * lapF + k0 - k2 * (Uc - P.Tm);
  }
  dU = lapU + P.L * dF + fu;
}

// A fence with acquire and release semantics at device scope: what the
// ticket protocol of a launch that finishes its own reduction needs (K5,
// K8, K9), and lighter than __threadfence()'s sequentially consistent one.
// Before a relaxed atomic it releases this thread's writes to whoever reads
// the atomic's result; after one, it acquires what the writers released.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// max that keeps a NaN from either side (fmaxf would drop it): an error
// estimate that is NaN must never read as converged.
template <class Real>
__device__ __forceinline__ Real nan_max(Real a, Real b) {
  return (b > a || b != b) ? b : a;
}

// a mod n in [0, n) for any sign of a
__device__ __forceinline__ int wrap(int a, int n) {
  int m = a % n;
  return m < 0 ? m + n : m;
}

// ---------------------------------------------------------- ensembles ----
//
// The batched kernels of rhs.cu and cg.cu step the members of an ensemble
// in one launch, as the JAX package's `jax.vmap` of the stepper lifts each
// pallas_call's grid by a leading member dimension
// (`tests/test_pallas_dd.py:85-90`).  The fields are stacked (B, ny, nx);
// one grid dimension indexes the members the launch steps (`Members`), so
// a member the host froze, that finished its retries or whose CG solve
// stopped costs nothing and its rows are left as they are.  Each member's
// blocks run the unbatched kernel's body on its own (ny, nx) slice: member
// b's output equals the unbatched kernel's on member b's fields bit for
// bit.

// At most this many members a launch (a parameter of 1.3 KB at double);
// the host splits a larger live set into several launches.
constexpr int kMaxMembers = 64;

// The members a batched launch steps: member z of the launch is ensemble
// member id[z], whose fields start at id[z] * ny * nx, with its own step
// size tau[z] (K2) and forcing fu[z] (the explicit kernels: the forcing
// reads the member's iteration count; the CG kernels read neither).
// Passed by value as a __grid_constant__ parameter, so no copy to the card
// precedes a launch and a block reads its member's entries from the
// parameter bank.  Mirrored by ops/cuda_rhs.py:_Members.
template <class Real>
struct Members {
  int id[kMaxMembers];
  Real tau[kMaxMembers];
  Real fu[kMaxMembers];
};

// A batched launch's member count, 1..kMaxMembers (far below the grid's
// caps of 65535 in y and z)
inline bool members_ok(int count) { return count >= 1 && count <= kMaxMembers; }

// Where launch member z's (ny, nx) fields start in the stack
template <class Real>
__device__ __forceinline__ size_t member_offset(const Members<Real>& m, int z, int ny, int nx) {
  return size_t(m.id[z]) * size_t(ny) * size_t(nx);
}

// Member id's Halo on a shard whose ghosts are member-major, rows (B, 2
// sides, 2 fields, nx) and cols (B, 2, 2, ny): its rows start at id times
// one member's 4 n values.  The whole grid's null ghosts stay null.  The
// mesh kernels over members of rhs.cu and cg.cu share it.
template <class Real>
__device__ __forceinline__ Halo<Real> member_halo(Halo<Real> h, int id, int ny, int nx) {
  if (h.rows != nullptr) h.rows += size_t(id) * 4 * nx;
  if (h.cols != nullptr) h.cols += size_t(id) * 4 * ny;
  return h;
}

}  // namespace bt
