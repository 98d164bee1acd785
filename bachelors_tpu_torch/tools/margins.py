"""How far K2 and K12.2 are from a float64 evaluation of the same Merson
attempt, beside their plain versions.

    python -m bachelors_tpu_torch.tools.margins [--draws 64] [--size 512] [--seed 0]
                                                [--device cuda] [--out FILE]

A whole float32 Merson attempt on standard-normal fields is stiff: its
five stages amplify each rounding, so a kernel that rounds apart from its
plain version (an FMA where the plain version rounds a product and a sum
apart) can differ from it by far more than an ulp.  This tool measures
whether the kernel is the one that strays.
For ``--draws`` draws per boundary pair of ``chip_smoke.py``'s
``BC_PAIRS``, at ``--size``^2, S = 0.25, m0 = 6, tau = ``TAU`` (the
fields drawn as ``chip_smoke.fields`` draws them: F, then U, each
``rng.normal(size=(n, n))`` cast to float32), it runs on the same float32
inputs:

  * K2 (``cuda_rhs.rkm_attempt``) and its plain version;
  * K12.2 (``cuda_rhs.rkm_attempt_sharded``) on each shard of a y(2) mesh
    of the one card, and its plain version, each joined over the shards;
  * a float64 evaluation of the same attempt: the plain version on the
    inputs cast to float64, tau = float64(float32(TAU)), float64
    transcendentals (``f64_attempt``).

Per draw and field, three gaps, each max|a - b| / max(max|f64|, 1):
kernel - plain, kernel - f64 and plain - f64 (the larger of the two
fields).  Prints one JSON object: per kernel and BC pair and over all
draws, the max, p99 and median of each gap, the largest ratio of the
kernel's distance from f64 to the plain version's, and the verdict: a
draw where the kernel is farther from f64 than 2x the plain version plus
2 ulp of scale (``within_margin``) is a fault of the kernel; none is a
standing difference of float32 rounding.  Needs a CUDA device unless
``--device cpu`` (a rehearsal, where the wrappers take their plain
versions).
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core.device import resolve_device, warm_cpu_math
from ..core.params import BoundaryType, SimParams
from ..ops import cuda_rhs
from ..parallel.mesh import make_mesh, shard_field

# chip_smoke.py's boundary pairs (Phi, T; None: T as Phi), its Merson step
# size, and the fu and Dirichlet value of its kernel checks
BC_PAIRS = (("periodic", None), ("neumann", None), ("dirichlet", None),
            ("periodic", "dirichlet"), ("periodic", "neumann"))
TAU = 3.7e-6
FU = 0.03
# float32's ulp at 1: a gap of "2 ulp of scale" is 2 * F32_ULP
F32_ULP = float(np.finfo(np.float32).eps)
GAPS = ("kernel_plain", "kernel_f64", "plain_f64")


def params(n: int, f_bc: str, u_bc=None, S=0.25, m0=6.0) -> SimParams:
    """``chip_smoke.params`` at n x n."""
    return SimParams(ny=n, nx=n, S=S, m0=m0, theta0=0.1, Phi_boundary=BoundaryType(f_bc),
                     T_boundary=BoundaryType(u_bc or f_bc))


def dirichlet_value(p: SimParams) -> float:
    return 0.25 if BoundaryType.DIRICHLET in (p.Phi_boundary, p.T_boundary) else 0.0


def f64_attempt(F: torch.Tensor, U: torch.Tensor, tau, p: SimParams, fu=FU,
                dirichlet=0.0):
    """The Merson attempt from the same float32 inputs evaluated in float64:
    the plain version on the fields cast to float64, tau cast from its
    float32 value, float64 transcendentals.  Returns (F, U, emax) at
    float64."""
    p64 = p.replace(dtype="float64", f32_transcendentals=False)
    return cuda_rhs.rkm_attempt_plain(F.double(), U.double(), np.float64(np.float32(tau)),
                                      p64, fu, dirichlet)


def gap(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
        ref: Sequence[torch.Tensor]) -> float:
    """max over the two fields of max|a - b| / max(max|ref|, 1), in float64;
    NaN anywhere counts as infinite."""
    worst = 0.0
    for x, y, r in zip(a, b, ref):
        d = (x.double() - y.double()).abs().max().item()
        if not np.isfinite(d):
            return float("inf")
        worst = max(worst, d / max(r.double().abs().max().item(), 1.0))
    return worst


def within_margin(kernel_f64: float, plain_f64: float) -> bool:
    """The kernel no farther from the float64 result than 2x its plain
    version is, plus 2 ulp of scale."""
    return kernel_f64 <= 2.0 * plain_f64 + 2.0 * F32_ULP


def draw(rng: np.random.Generator, n: int, device) -> tuple:
    """One (F, U) pair as ``chip_smoke.fields`` draws it."""
    return tuple(torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32)).to(device)
                 for _ in range(2))


def distribution(values: List[float]) -> Dict[str, float]:
    v = np.asarray(values, dtype=np.float64)
    return {"max": float(v.max()), "p99": float(np.percentile(v, 99)),
            "median": float(np.median(v))}


def measure(draws: int, n: int, seed: int, device) -> dict:
    rng = np.random.default_rng(seed)
    tau = np.float32(TAU)
    mesh, topo = make_mesh(2, 1, [device] * 2)
    rows: Dict[str, Dict[str, Dict[str, List[float]]]] = {"K2": {}, "K12.2": {}}
    worst = {"K2": None, "K12.2": None}
    per_draw = []
    for f_bc, u_bc in BC_PAIRS:
        p = params(n, f_bc, u_bc)
        d = dirichlet_value(p)
        pair = f"{f_bc}/{u_bc or f_bc}"
        for k in rows:
            rows[k][pair] = {g: [] for g in (*GAPS, "ratio")}
        for i in range(draws):
            F, U = draw(rng, n, device)
            ref = f64_attempt(F, U, tau, p, FU, d)[:2]
            k2 = cuda_rhs.rkm_attempt(F, U, tau, p, FU, d)[:2]
            pl = cuda_rhs.rkm_attempt_plain(F, U, tau, p, FU, d)[:2]
            Fs, Us = shard_field(F, mesh, topo), shard_field(U, mesh, topo)
            aprons = topo.apron(Fs, Us, cuda_rhs.SLAB_ROWS)
            k12 = [cuda_rhs.rkm_attempt_sharded(f, u, ap, tau, p, FU, d)
                   for f, u, ap in zip(Fs.blocks, Us.blocks, aprons)]
            p12 = [cuda_rhs.rkm_attempt_sharded_plain(f, u, ap, tau, p, FU, d)
                   for f, u, ap in zip(Fs.blocks, Us.blocks, aprons)]
            joined = {name: [torch.cat([o[j] for o in outs]) for j in (0, 1)]
                      for name, outs in (("K12.2", k12), ("K12.2 plain", p12))}
            for k, (kern, plain) in (("K2", (k2, pl)),
                                     ("K12.2", (joined["K12.2"], joined["K12.2 plain"]))):
                g = {"kernel_plain": gap(kern, plain, ref), "kernel_f64": gap(kern, ref, ref),
                     "plain_f64": gap(plain, ref, ref)}
                g["ratio"] = g["kernel_f64"] / max(g["plain_f64"], 1e-300)
                for name, v in g.items():
                    rows[k][pair][name].append(v)
                per_draw.append({"kernel": k, "pair": pair, "draw": i, **g})
                if worst[k] is None or g["ratio"] > worst[k]["ratio"]:
                    worst[k] = {"pair": pair, "draw": i, **g,
                                "within_margin": within_margin(g["kernel_f64"],
                                                               g["plain_f64"])}
    out = {}
    for k, by_pair in rows.items():
        every = {g: [v for r in by_pair.values() for v in r[g]] for g in (*GAPS, "ratio")}
        fails = [(pair, i) for pair, r in by_pair.items()
                 for i, (kf, pf) in enumerate(zip(r["kernel_f64"], r["plain_f64"]))
                 if not within_margin(kf, pf)]
        # the mirror: draws where the plain version strays as far from the
        # kernel's distance as the margin lets the kernel stray from its
        mirror = sum(not within_margin(pf, kf) for r in by_pair.values()
                     for kf, pf in zip(r["kernel_f64"], r["plain_f64"]))
        out[k] = {"all": {g: distribution(every[g]) for g in (*GAPS, "ratio")},
                  "by_pair": {pair: {g: distribution(r[g]) for g in GAPS}
                              for pair, r in by_pair.items()},
                  "largest_ratio": worst[k],
                  "draws_beyond_margin": len(fails), "first_beyond": fails[:5],
                  "plain_beyond_mirror_margin": mirror,
                  "bit_for_bit_draws": sum(v == 0.0 for v in every["kernel_plain"]),
                  "verdict": "fault of the kernel" if fails else
                             "standing difference (float32 rounding)"}
    return out, per_draw


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        warm_cpu_math()
    result = {"tool": "margins", "device": str(dev),
              "card": card() if dev.type == "cuda" else "cpu (plain versions)",
              "draws_per_pair": args.draws, "size": args.size, "seed": args.seed,
              "S": 0.25, "m0": 6.0, "tau": TAU, "fu": FU,
              "gaps": "max|a - b| / max(max|f64|, 1), the larger of the two fields",
              "margin": "kernel_f64 <= 2 plain_f64 + 2 * 2^-23",
              "draws": args.draws * len(BC_PAIRS)}
    summary, per_draw = measure(args.draws, args.size, args.seed, dev)
    result.update(summary)
    print(json.dumps(result), flush=True)
    if args.out:  # with every draw's gaps
        with open(args.out, "w") as f:
            f.write(json.dumps({**result, "per_draw": per_draw}) + "\n")


if __name__ == "__main__":
    main()
