"""5-point stencil linear operators for the semi-implicit (CG) path.

The port of ``bachelors_tpu/ops/stencil.py`` on one device: the
reference's matrix-free operators
  * ``cross_matvec``      <-> ``cross_matrix_static_multiply`` (`simulation.cu:528-549`)
  * ``anisotropy_matvec`` <-> ``anisotrophy_matrix_multiply`` (`simulation.cu:551-578`)
over fields padded by ``core/boundary.pad2`` with Dirichlet value 0.  These
are the plain versions of the CG matvec kernel (``ops/cuda_cg.py``, K8).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.boundary import pad2
from ..core.params import BoundaryType, SimParams


@dataclasses.dataclass(frozen=True)
class CrossMatrix:
    """Constant 5-point operator  A = C*I + X*(E + W) + Y*(N + S).

    For the implicit heat system (`simulation.cu:782-791`):
      C = 1 + 2*dt/dx^2 + 2*dt/dy^2,  X = -dt/dx^2,  Y = -dt/dy^2.
    """

    C: float
    X: float  # east/west coefficient
    Y: float  # north/south coefficient
    boundary: BoundaryType

    @staticmethod
    def implicit_heat(p: SimParams) -> "CrossMatrix":
        dt, dx, dy = p.dt, p.dx, p.dy
        return CrossMatrix(
            C=1 + 2 * dt / (dx * dx) + 2 * dt / (dy * dy),
            X=-dt / (dx * dx),
            Y=-dt / (dy * dy),
            boundary=p.T_boundary,
        )


def cross_matvec(A: CrossMatrix, v: torch.Tensor) -> torch.Tensor:
    vp = pad2(v, A.boundary)
    return (
        A.C * vp[1:-1, 1:-1]
        + A.X * (vp[1:-1, 2:] + vp[1:-1, :-2])
        + A.Y * (vp[2:, 1:-1] + vp[:-2, 1:-1])
    )


@dataclasses.dataclass(frozen=True)
class AnisotropyMatrix:
    """Variable-coefficient 5-point operator for the implicit phase system.

    With the per-cell coefficient map s (from the prepare):
      (A v)_ij = (1 + Cm1*s_ij) v_ij + X*s_ij (E+W) + Y*s_ij (N+S)
    where Cm1 = 2*dt/dx^2 + 2*dt/dy^2, X = -dt/dx^2, Y = -dt/dy^2
    (`simulation.cu:772-780,562-577`).
    """

    Cm1: float
    X: float
    Y: float
    boundary: BoundaryType

    @staticmethod
    def implicit_phase(p: SimParams) -> "AnisotropyMatrix":
        dt, dx, dy = p.dt, p.dx, p.dy
        return AnisotropyMatrix(
            Cm1=2 * dt / (dx * dx) + 2 * dt / (dy * dy),
            X=-dt / (dx * dx),
            Y=-dt / (dy * dy),
            boundary=p.Phi_boundary,
        )


def anisotropy_matvec(A: AnisotropyMatrix, s, v: torch.Tensor) -> torch.Tensor:
    """``s`` is the per-cell map, or a Python float where it is constant."""
    vp = pad2(v, A.boundary)
    return (
        (1 + A.Cm1 * s) * vp[1:-1, 1:-1]
        + (A.X * s) * (vp[1:-1, 2:] + vp[1:-1, :-2])
        + (A.Y * s) * (vp[2:, 1:-1] + vp[:-2, 1:-1])
    )


def lap_from_padded(vp: torch.Tensor, p: SimParams) -> torch.Tensor:
    """5-point Laplacian of a padded field (the JAX package's
    ``solvers/semi_implicit._lap_from_padded``)."""
    return ((vp[1:-1, 2:] - 2 * vp[1:-1, 1:-1] + vp[1:-1, :-2]) / (p.dx * p.dx)
            + (vp[2:, 1:-1] - 2 * vp[1:-1, 1:-1] + vp[:-2, 1:-1]) / (p.dy * p.dy))


def laplacian(v: torch.Tensor, bc: BoundaryType, p: SimParams) -> torch.Tensor:
    """Plain 5-point Laplacian with BC ghost cells."""
    return lap_from_padded(pad2(v, bc), p)
