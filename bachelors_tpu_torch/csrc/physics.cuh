// Physics body and boundary rule shared by the port's CUDA kernels.
//
// The counterpart of `bachelors_tpu/ops/pallas_rhs.py:_make_physics` (:220),
// written with the arithmetic of the plain version
// `bachelors_tpu_torch/models/allen_cahn.py:rhs_padded`: g(theta) comes from
// atan2f/cosf, as the oracle has it, so the integer-m0 recurrence
// `_g_theta_vpu` (:199) and its gate on m0 are gone.  Built without
// --use_fast_math: atan2f, cosf, sqrtf and the division are the accurate
// versions.  nvcc contracts mul+add into FMA, so results differ from the
// CPU's in the last bits; compare with tolerances.
//
// Layout: fields are (ny, nx), row-major, y on axis 0.  N is row i+1, S is
// row i-1, E is column j+1, W is column j-1.
#pragma once

#include <cuda_runtime.h>

namespace bt {

// BoundaryType, as numbered by ops/cuda_rhs.py
enum Bc : int { kPeriodic = 0, kNeumann = 1, kDirichlet = 2 };

// Coefficients of one configuration, computed on the host in double and
// rounded to float once (as the JAX package rounds its Python-float
// constants against float32 arrays).  Mirrored by ops/cuda_rhs.py:_Phys.
struct PhysParams {
  float inv_2dx, inv_2dy, inv_dx2, inv_dy2;
  float k0_factor, k1_factor, k2_factor;
  float dt, dt_L, L, Tm;
  float S, m0, theta0;
  float gamma;  // the semi-implicit scheme's implicitness blend
  int f_bc, u_bc;
  int corrector_guess;
};

// The image of centre value `c` across a Neumann or Dirichlet edge.
__device__ __forceinline__ float edge_image(int bc, float c, float d) {
  return bc == kNeumann ? c : 2.0f * d - c;
}

// Neighbour value as the padded field holds it.  `cross` says that the step
// from the cell to this neighbour crosses a domain edge.  A periodic field
// reads the wrapped neighbour `nb`; Neumann clamps to the cell's own value;
// Dirichlet mirrors it through d: 2*d - centre (core/boundary.py:pad2).
__device__ __forceinline__ float neighbour(int bc, bool cross, float nb,
                                           float centre, float d) {
  if (!cross || bc == kPeriodic) return nb;
  return edge_image(bc, centre, d);
}

// The four neighbours of cell (i, j) of a (ny, nx) field A whose own value
// is c, as the padded field holds them: wrapped for a periodic field, the
// edge image otherwise.  Device memory is read only where the rule needs it.
struct Cross {
  float N, S, E, W;
};

__device__ __forceinline__ Cross cross_of(const float* __restrict__ A, int bc,
                                          float c, float d, int i, int j,
                                          int ny, int nx) {
  const bool img = bc != kPeriodic;
  Cross n;
  n.N = (i + 1 == ny) ? (img ? edge_image(bc, c, d) : A[j]) : A[(i + 1) * nx + j];
  n.S = (i == 0) ? (img ? edge_image(bc, c, d) : A[(ny - 1) * nx + j])
                 : A[(i - 1) * nx + j];
  n.E = (j + 1 == nx) ? (img ? edge_image(bc, c, d) : A[i * nx]) : A[i * nx + j + 1];
  n.W = (j == 0) ? (img ? edge_image(bc, c, d) : A[i * nx + nx - 1])
                 : A[i * nx + j - 1];
  return n;
}

// g(theta) = 1 - S cos(m0 theta + theta0) and |grad Phi| from the central
// differences; atan2(0, 0) = 0 and |grad| = 0 there
// (models/allen_cahn.py:_anisotropy).
__device__ __forceinline__ void anisotropy(const PhysParams& P, float gx,
                                           float gy, float& g, float& norm) {
  float r2 = gx * gx + gy * gy;
  bool zero = r2 == 0.0f;
  float theta = atan2f(gy, zero ? 1.0f : gx);
  g = 1.0f - P.S * cosf(P.m0 * theta + P.theta0);
  norm = zero ? 0.0f : sqrtf(r2);
}

// (dPhi/dt, dT/dt) at one cell from its own and its four neighbours'
// values (`simulation.cu:201-230`).
__device__ __forceinline__ void physics(const PhysParams& P, float Fc,
                                        float FN, float FS, float FE, float FW,
                                        float Uc, float UN, float US, float UE,
                                        float UW, float fu, float& dF,
                                        float& dU) {
  float g, norm;
  anisotropy(P, (FE - FW) * P.inv_2dx, (FN - FS) * P.inv_2dy, g, norm);

  float lapF = (FW - 2.0f * Fc + FE) * P.inv_dx2 + (FS - 2.0f * Fc + FN) * P.inv_dy2;
  float lapU = (UW - 2.0f * Uc + UE) * P.inv_dx2 + (US - 2.0f * Uc + UN) * P.inv_dy2;

  float k0 = g * (Fc * (1.0f - Fc) * (Fc - 0.5f)) * P.k0_factor;
  float k2 = norm * P.k2_factor;
  float k1 = g * P.k1_factor;

  if (P.corrector_guess) {
    float corr = 1.0f + k2 * P.dt_L;
    dF = (k1 * lapF + k0 - k2 * (Uc - P.Tm + P.dt * lapU)) / corr;
  } else {
    dF = k1 * lapF + k0 - k2 * (Uc - P.Tm);
  }
  dU = lapU + P.L * dF + fu;
}

// max that keeps a NaN from either side (fmaxf would drop it): an error
// estimate that is NaN must never read as converged.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// a mod n in [0, n) for any sign of a
__device__ __forceinline__ int wrap(int a, int n) {
  int m = a % n;
  return m < 0 ? m + n : m;
}

}  // namespace bt
