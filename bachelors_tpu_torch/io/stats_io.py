"""Stats accumulation + CSV schema identical to the reference.

The port's ``bachelors_tpu/io/stats_io.py`` (reference ``App_Stats``,
`main.cpp:192-234`, and ``save_csv_stat_file``, `main.cpp:782-823`): first
line ``nx,ny,dt``, then a quoted header row with the 12 base columns, then
one row per collected step; successive snapshots append and the collected
rows are cleared after each write (`main.cpp:867-893`).  Readable by the
reference's ``plot.py:104-205`` loader.

Rows keep their delta statistics on the device until a flush, which copies
them to the host in one transfer.  The 4 columns per corrector iteration
arrive with the corrector loop (ROADMAP slice 2); no ported solver has one.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..core.state import DELTA_NAMES, StepStats

BASE_COLUMNS = ("time", "iter", "Phi_iters", "T_iters") + DELTA_NAMES


@dataclasses.dataclass
class StatsAccumulator:
    rows: List[StepStats] = dataclasses.field(default_factory=list)
    writes: int = 0

    def collect(self, s: StepStats) -> None:
        """Append one step's stats (``s.deltas`` must be set: stats on)."""
        if s.deltas is None:
            raise ValueError("step stats carry no deltas; set p.do_stats")
        self.rows.append(s)

    def save_csv(self, path: str, nx: int, ny: int, dt: float) -> None:
        """Write-or-append, then clear (reference snapshot-flush protocol).

        An empty FIRST flush is skipped entirely, as in the JAX package."""
        if not self.rows and self.writes == 0:
            return
        append = self.writes != 0
        deltas = (torch.stack([r.deltas for r in self.rows]).cpu().numpy()
                  if self.rows else np.zeros((0, len(DELTA_NAMES)), np.float32))
        lines = []
        if not append:
            lines.append(f"{nx},{ny},{dt:f}")
            lines.append(",".join(f'"{c}"' for c in BASE_COLUMNS))
        for r, d in zip(self.rows, deltas):
            vals = [f"{r.t:f}", str(r.iter), str(r.Phi_iters), str(r.T_iters)]
            vals += [f"{float(v):f}" for v in d]
            lines.append(",".join(vals))
        with open(path, "ab" if append else "wb") as f:
            f.write("".join(line + "\n" for line in lines).encode())
        self.rows.clear()
        self.writes += 1
