"""Ensemble study: nucleation sensitivity to initial-temperature noise.

The port of ``examples/ensemble_noise.py``: B independent simulations run
as one ensemble on one device (``parallel/sharded.make_ensemble_stepper``,
each RK4 stage one batched launch for every member), each with a different
Perlin-noise perturbation of the initial undercooling, and the ensemble
mean and standard deviation of the phase field are written as
``mean.npy`` and ``std.npy`` in ``--out`` (the JAX example plots them).

Usage:
    python -m bachelors_tpu_torch.examples.ensemble_noise [--members 8]
        [--size 256] [--steps 4000] [--out ensemble_out] [--device cuda]

The default device is the card; ``--device cpu`` runs the plain versions.
Equivalent driver run: ``--set tpu.ensemble=8 --set initial.noise_T=0.02``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.params import SimParams, SolverType
from ..core.state import make_state, stack_states
from ..models.initial import InitialConditions, make_initial_fields
from ..parallel.sharded import make_ensemble_stepper


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--out", default="ensemble_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n = args.size
    p = SimParams(nx=n, ny=n, L0=4.0 * n / 512, solver=SolverType.EXPLICIT_RK4,
                  dt=5e-6, S=0.3, m0=6.0, theta0=0.1, dtype="float32")
    # per-member initial conditions: the same seed crystal, different noise
    members = []
    for seed in range(args.members):
        F, U = make_initial_fields(p, InitialConditions(
            circle_center=(p.L0 / 2, p.L0 / 2), circle_radius=p.L0 / 60,
            circle_fade=4.0, noise_T=args.noise, noise_seed=seed), device=device)
        members.append(make_state(F, U, p, device=device))
    state = stack_states(members)
    step = make_ensemble_stepper(p)

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _stats = step(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rate = args.members * args.steps / wall
    print(f"{args.members} members x {args.steps} RK4 steps at {n}^2 on {device}: "
          f"{wall:.2f}s ({rate:.0f} member-steps/s)")

    F = state.F.cpu().numpy()  # (B, ny, nx)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "mean.npy"), F.mean(axis=0))
    np.save(os.path.join(args.out, "std.npy"), F.std(axis=0))
    print(f"wrote {args.out}/mean.npy, {args.out}/std.npy")
    return {"wall_s": wall, "member_steps_per_s": rate, "std_max": float(F.std(axis=0).max())}


if __name__ == "__main__":
    main()
