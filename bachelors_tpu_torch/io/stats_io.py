"""Stats accumulation + CSV schema identical to the reference.

The port's ``bachelors_tpu/io/stats_io.py`` (reference ``App_Stats``,
`main.cpp:192-234`, and ``save_csv_stat_file``, `main.cpp:782-823`): first
line ``nx,ny,dt``, then a quoted header row with the 12 base columns plus 4
per live corrector iteration, then one row per collected step; successive
snapshots append and the collected rows are cleared after each write
(`main.cpp:867-893`).  Readable by the reference's ``plot.py:104-205``
loader.

Rows keep their delta statistics and step residuals on the device until a
flush, which copies each kind to the host in one transfer.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.state import DELTA_NAMES, STEP_RES_NAMES, StepStats

BASE_COLUMNS = ("time", "iter", "Phi_iters", "T_iters") + DELTA_NAMES


@dataclasses.dataclass
class StatsAccumulator:
    rows: List[StepStats] = dataclasses.field(default_factory=list)
    step_res_count: int = 0
    writes: int = 0

    def collect(self, s: StepStats) -> None:
        """Append one step's stats (``s.deltas`` must be set: stats on)."""
        if s.deltas is None:
            raise ValueError("step stats carry no deltas; set p.do_stats")
        if s.step_res is not None:
            self.step_res_count = max(self.step_res_count, s.step_res.shape[0])
        self.rows.append(s)

    def save_csv(self, path: str, nx: int, ny: int, dt: float) -> None:
        """Write-or-append, then clear (reference snapshot-flush protocol).

        An empty FIRST flush is skipped entirely, as in the JAX package: the
        header's residual columns are sized from ``step_res_count``, which
        is known only once rows exist."""
        if not self.rows and self.writes == 0:
            return
        append = self.writes != 0
        deltas = (torch.stack([r.deltas for r in self.rows]).cpu().numpy()
                  if self.rows else np.zeros((0, len(DELTA_NAMES)), np.float32))
        with_res = [r.step_res for r in self.rows if r.step_res is not None]
        res = iter(torch.cat(with_res).cpu().numpy()) if with_res else iter(())
        lines = []
        if not append:
            lines.append(f"{nx},{ny},{dt:f}")
            cols = list(BASE_COLUMNS)
            for k in range(self.step_res_count):
                cols += [f"{name}[{k}]" for name in STEP_RES_NAMES]
            lines.append(",".join(f'"{c}"' for c in cols))
        for r, d in zip(self.rows, deltas):
            vals = [f"{r.t:f}", str(r.iter), str(r.Phi_iters), str(r.T_iters)]
            vals += [f"{float(v):f}" for v in d]
            n = 0 if r.step_res is None else r.step_res.shape[0]
            for k in range(self.step_res_count):
                vals += ([f"{float(v):f}" for v in next(res)] if k < n
                         else [""] * len(STEP_RES_NAMES))
            lines.append(",".join(vals))
        with open(path, "ab" if append else "wb") as f:
            f.write("".join(line + "\n" for line in lines).encode())
        self.rows.clear()
        self.writes += 1
