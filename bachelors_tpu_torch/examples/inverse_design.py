"""Inverse design by differentiating through the simulation.

The port of ``examples/inverse_design.py``: optimises the initial
undercooling field so that after a fixed rollout the solid phase fraction
hits a target, by gradient descent straight through the coupled PDE
integrator.  ``torch.autograd.grad`` of the rollout's mean Phi against the
target gives the gradient; each iteration takes a normalised step on U0.

The rollout runs forward Euler on the plain backend (``backend = "xla"``,
as the JAX example sets): torch ops carry the gradient, where a
hand-written kernel has no backward (its wrappers refuse a tensor that
requires grad).  The semi-implicit solver differentiates on the kernels
too, with ``SimParams(differentiable=True)``.

Usage:
    python -m bachelors_tpu_torch.examples.inverse_design [--target 0.04]
        [--iters 30] [--steps 20] [--lr 0.02] [--size 96] [--device cuda]

The default device is the card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.device import resolve_device
from ..core.params import SimParams, SolverType
from ..core.state import make_state
from ..models.initial import InitialConditions, make_initial_fields
from ..solvers.base import make_stepper


def problem(size: int, steps: int, target: float, device):
    """(params, U_init, rollout, loss_and_grad) of the JAX example's
    problem on a ``size``² grid: ``rollout(U0)`` the mean Phi after
    ``steps`` Euler steps, ``loss_and_grad(U0)`` (loss, dloss/dU0) with
    loss = (rollout - target)^2."""
    p = SimParams(nx=size, ny=size, L0=4.0, dt=5e-6, S=0.25, m0=6.0,
                  solver=SolverType.EXPLICIT_EULER, dtype="float32", backend="xla")
    F0, U_init = make_initial_fields(p, InitialConditions(
        circle_center=(2.0, 2.0), circle_radius=0.4, circle_fade=6.0), device=device)
    step = make_stepper(p)

    def rollout(U0: torch.Tensor) -> torch.Tensor:
        st = make_state(F0, U0, p, device=device)
        for _ in range(steps):
            st, _stats = step(st)
        return torch.mean(st.F)

    def loss_and_grad(U0: torch.Tensor):
        u = U0.detach().requires_grad_()
        loss = (rollout(u) - target) ** 2
        g, = torch.autograd.grad(loss, u)
        return loss.detach(), g

    return p, U_init, rollout, loss_and_grad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", type=float, default=0.04)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    _p, U_init, rollout, loss_and_grad = problem(args.size, args.steps, args.target, device)
    U0 = U_init.clone()
    with torch.no_grad():
        frac0 = float(rollout(U0))
    print(f"initial phase fraction after rollout: {frac0:.5f} (target {args.target})")

    losses = []
    t0 = time.perf_counter()
    for it in range(args.iters):
        loss, g = loss_and_grad(U0)
        # normalised gradient step: lr is in temperature units
        U0 = U0 - args.lr * g / torch.clamp(torch.abs(g).max(), min=1e-30)
        losses.append(float(loss))
        if it % 5 == 0 or it == args.iters - 1:
            print(f"  iter {it:3d}: loss {losses[-1]:.3e}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms_per_iter = (time.perf_counter() - t0) * 1e3 / max(args.iters, 1)

    with torch.no_grad():
        frac = float(rollout(U0))
    dU = float(torch.abs(U0 - U_init).max())
    print(f"optimized phase fraction: {frac:.5f} (|error| {abs(frac - args.target):.2e})")
    print(f"initial-field change: max |dU| = {dU:.4f}")
    return {"frac0": frac0, "frac": frac, "losses": losses, "max_dU": dU,
            "ms_per_iter": ms_per_iter}


if __name__ == "__main__":
    main()
